"""Chunk-policy tests.

The old `_chunk_size` required an exact divisor <= target, so a batch with
no small divisor (a prime byte count, or 37 CTR blocks) degenerated to
chunk 1 — B sequential one-element dispatches.  The balanced policy picks
ceil(b / ceil(b/target)) and callers pad the ragged tail (waste < one
chunk).  Reference analog: any --number-of-outputs is first-class
(/root/reference/src/main.rs:20-30).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tfhe_aes_tpu.ops.wopbs import _chunk_size
from tfhe_aes_tpu.models import fhe_aes


@pytest.mark.parametrize("b,target,want_chunk,want_n", [
    (37, 32, 19, 2),      # prime: old policy gave chunk 1 -> 37 dispatches
    (257, 256, 129, 2),   # prime byte count: old policy gave 257 dispatches
    (64, 32, 32, 2),      # exact multiple: unchanged
    (96, 32, 32, 3),
    (16, 32, 16, 1),      # small batches stay unchunked
    (33, 32, 17, 2),
])
def test_chunk_size_balanced(b, target, want_chunk, want_n):
    bc = _chunk_size(b, target)
    assert bc == want_chunk
    assert -(-b // bc) == want_n
    assert bc <= target


def test_ctr_keystream_dispatch_count(monkeypatch):
    """ctr_keystream(n_blocks=37) must dispatch <=2 AES chunks
    and reassemble the batch exactly.  The AES program is stubbed (identity
    over the state) so this tests ONLY the chunk/pad/slice driver logic —
    the full-crypto equivalence lives in
    test_fhe_aes_toy.test_ctr_keystream_chunked_matches_fused."""
    calls = []

    def fake_aes(keys, round_keys, state):
        calls.append(state.shape[0])
        return state

    def fake_add_scalar(keys, state, lut_lsb, luts_rest):
        return state

    monkeypatch.setattr(fhe_aes, "aes_encrypt_jit", fake_aes)
    monkeypatch.setattr(fhe_aes, "add_scalar_device_jit", fake_add_scalar)

    from types import SimpleNamespace
    from tfhe_aes_tpu.params import PARAM_TOY
    keys = SimpleNamespace(params=PARAM_TOY)
    n_blocks = 37
    enc_iv = jnp.arange(16 * 8 * 4, dtype=jnp.uint64).reshape(16, 8, 4)
    out = fhe_aes.ctr_keystream(keys, None, enc_iv, n_blocks,
                                block_chunk=32)
    assert calls == [19, 19]          # balanced chunks, one compiled shape
    assert out.shape[0] == n_blocks
    np.testing.assert_array_equal(
        np.asarray(out), np.broadcast_to(np.asarray(enc_iv)[None],
                                         (n_blocks, 16, 8, 4)))
