"""End-to-end FHE AES-128 at toy parameters vs the plaintext oracle (CPU).

Mirrors the reference's oracle-based test strategy (SURVEY.md section 4):
every decrypted FHE result must be bit-exact against numpy AES.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu.client.client import Client
from tfhe_aes_tpu.models import aes_plain, fhe_aes

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF


@pytest.fixture(scope="module")
def ctx():
    client = Client(PARAM_TOY, seed=11)
    dkeys = client.make_device_keys()
    return client, dkeys


def _encrypt_round_keys(client, key):
    """Client-side-encrypted expanded key (isolates encrypt from expansion)."""
    rks = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(key))
    return jnp.stack([
        jnp.asarray(np.stack([client.encrypt_byte(b) for b in rk]))
        for rk in rks])


@pytest.mark.slow
def test_aes_encrypt_matches_oracle(ctx):
    client, dkeys = ctx
    rks = _encrypt_round_keys(client, KEY)
    pts = [IV, 0x6BC1BEE22E409F96E93D7E117393172A]
    state = jnp.asarray(np.stack([client.encrypt_u128(p) for p in pts]))
    out = np.asarray(fhe_aes.aes_encrypt_jit(dkeys, rks, state))
    for i, pt in enumerate(pts):
        got = client.decrypt_state_u128(out[i])
        want = aes_plain.bytes_be_to_u128(aes_plain.encrypt_block(
            aes_plain.u128_to_bytes_be(KEY), aes_plain.u128_to_bytes_be(pt)))
        assert got == want, f"block {i}: {got:#x} != {want:#x}"


@pytest.mark.slow
def test_aes_decrypt_roundtrip(ctx):
    client, dkeys = ctx
    rks = _encrypt_round_keys(client, KEY)
    ct_plain = aes_plain.encrypt_block(aes_plain.u128_to_bytes_be(KEY),
                                       aes_plain.u128_to_bytes_be(IV))
    state = jnp.asarray(client.encrypt_u128(
        aes_plain.bytes_be_to_u128(ct_plain)))[None]
    out = np.asarray(fhe_aes.aes_decrypt_jit(dkeys, rks, state))
    assert client.decrypt_state_u128(out[0]) == IV


def test_key_expansion(ctx):
    """Default schedule: trivial noise-free RCON, 2 WoPBS per round."""
    client, dkeys = ctx
    enc_key = jnp.asarray(client.encrypt_u128(KEY))
    rks = np.asarray(fhe_aes.aes_key_expansion_jit(dkeys, enc_key))
    want = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    for r in range(11):
        got = [client.decrypt_byte(rks[r, i]) for i in range(16)]
        assert got == want[r], f"round key {r}"


@pytest.mark.slow
def test_key_expansion_pk_rcon(ctx):
    """Reference-faithful schedule: public-key RCON (server.rs:139-140)."""
    client, dkeys = ctx
    pk = client.make_public_key()
    rcon_bits = np.stack([
        np.array([(int(r) >> j) & 1 for j in range(8)], dtype=np.uint64)
        for r in fhe_aes.tables.RCON])
    rcon_cts = pk.encrypt_bits(rcon_bits, client.rng)
    enc_key = jnp.asarray(client.encrypt_u128(KEY))
    rks = np.asarray(fhe_aes.aes_key_expansion_jit(dkeys, enc_key,
                                               jnp.asarray(rcon_cts)))
    want = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    for r in range(11):
        got = [client.decrypt_byte(rks[r, i]) for i in range(16)]
        assert got == want[r], f"round key {r}"


@pytest.mark.slow
def test_ctr_keystream_chunked_matches_fused(ctx):
    """The >block_chunk keystream driver (full-batch ripple + per-chunk AES
    dispatches — the bench path for 64-block batches) must be bit-identical
    to the single fused ctr_step program.  n_blocks=3 with block_chunk=2
    exercises the RAGGED tail (chunks [2, 1+wrap-pad], round-5 chunking
    policy) as well as the chunk boundary; marked slow because two full
    toy CTR keystreams dominate constrained CI runs."""
    client, dkeys = ctx
    enc_key = jnp.asarray(client.encrypt_u128(KEY))
    enc_iv = jnp.asarray(client.encrypt_u128(IV))
    rks = fhe_aes.aes_key_expansion_jit(dkeys, enc_key)
    fused = np.asarray(fhe_aes.ctr_keystream(dkeys, rks, enc_iv, 3,
                                             offset=7, block_chunk=3))
    chunked = np.asarray(fhe_aes.ctr_keystream(dkeys, rks, enc_iv, 3,
                                               offset=7, block_chunk=2))
    assert np.array_equal(fused, chunked)
    client.decrypt_and_verify_ctr(chunked, KEY, IV, offset=7)


def test_key_expansion_staged_matches_one_program(ctx):
    """The staged schedule (11 dispatches of ONE compiled WoPBS — the
    cold-compile path) must produce bit-identical round keys to the
    single-program scan."""
    client, dkeys = ctx
    enc_key = jnp.asarray(client.encrypt_u128(KEY))
    a = np.asarray(fhe_aes.aes_key_expansion_jit(dkeys, enc_key))
    b = np.asarray(fhe_aes.aes_key_expansion_staged(dkeys, enc_key))
    assert np.array_equal(a, b)


def test_add_scalar_carry_chain(ctx):
    client, dkeys = ctx
    iv = 0x000000000000000000000000000001FF  # forces multi-byte carries
    state = jnp.asarray(client.encrypt_u128(iv))[None]
    state = jnp.broadcast_to(state, (3,) + state.shape[1:])
    offs = [0, 1, 0x101]
    i_bytes = np.stack([np.array(aes_plain.u128_to_bytes_be(o),
                                 dtype=np.uint64) for o in offs])
    out = np.asarray(fhe_aes.add_scalar(dkeys, state, i_bytes))
    for bi, o in enumerate(offs):
        got = client.decrypt_state_u128(out[bi])
        assert got == (iv + o) % (1 << 128), f"offset {o:#x}"


def test_ctr_end_to_end(ctx):
    """Flagship config #1: key expansion + CTR + verify vs oracle, through
    the trust-boundary Server facade: the server side holds ONLY evaluation
    keys + the public key and pk-encrypts RCON itself (server.rs:139-140,
    main.rs:43-45)."""
    from tfhe_aes_tpu.server import Server
    client, dkeys = ctx
    server = Server(dkeys, client.make_public_key(),
                    rng=np.random.default_rng(7))
    enc_key = jnp.asarray(client.encrypt_u128(KEY))
    enc_iv = jnp.asarray(client.encrypt_u128(IV))
    rks = server.aes_key_expansion(enc_key, pk_rcon=True)
    ks = np.asarray(server.ctr_keystream(rks, enc_iv, 2))
    client.decrypt_and_verify_ctr(ks, KEY, IV)
