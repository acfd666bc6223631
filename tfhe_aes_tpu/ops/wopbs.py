"""Many-LUT WoPBS: the framework's first-class batched LUT-evaluation API.

Reference counterpart: many_wopbs_without_padding (many_wopbs.rs:31-116),
which the reference had to build by forking tfhe-rs internals so one circuit
bootstrap could feed several vertical packings (many_wopbs.rs:28-30).  Here
the split is the natural API:

    extract bits (batched keyswitch)  ->  circuit bootstrap (batched)
    ->  vertical packing over an arbitrary stack of LUT polynomials.

Ciphertext layout: a "byte" is its 8 bit-level big-LWE rows, LSB first
(radix block order, client.rs:126-129); batches lead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import cbs as cbs_mod
from . import keyswitch, vertical_packing
from .keys import DeviceKeys

U64 = jnp.uint64


def extract_bits(keys: DeviceKeys, byte_bits_big: jnp.ndarray) -> jnp.ndarray:
    """[..., nbits, big+1] u64 -> [..., nbits, n+1] small-LWE bits.

    With 1-bit radix blocks at delta 2^63 this is exactly one keyswitch per
    bit (reference extract_bits_assign degenerates likewise; SURVEY.md 2b).
    """
    return keyswitch.keyswitch(keys.params, keys.ksk_limbs, byte_bits_big)


def circuit_bootstrap_bits(keys: DeviceKeys,
                           bits_small: jnp.ndarray) -> jnp.ndarray:
    """[B, nbits, n+1] -> GGSW NTT stack [nbits, P, B, R2, k+1, N]."""
    Bb, nbits = bits_small.shape[0], bits_small.shape[1]
    flat = bits_small.reshape(Bb * nbits, -1)
    g = cbs_mod.circuit_bootstrap(keys, flat)   # [P, B*nbits, R2, k+1, N]
    P = g.shape[0]
    g = g.reshape((P, Bb, nbits) + g.shape[2:])
    return jnp.moveaxis(g, 2, 0)                # [nbits, P, B, R2, k+1, N]


def _stage_and_pack(keys: DeviceKeys, bigs: jnp.ndarray, Bb: int, nbits: int,
                    lut_polys_u64: jnp.ndarray) -> jnp.ndarray:
    """CBS tail + VP for one byte chunk: bigs [lev, Bb*nbits, big+1]."""
    g = cbs_mod.cbs_stage_ggsw(keys, bigs)      # [P, Bb*nbits, R2, k+1, N]
    P = g.shape[0]
    g = g.reshape((P, Bb, nbits) + g.shape[2:])
    ggsw = jnp.moveaxis(g, 2, 0)                # [nbits, P, Bb, R2, k+1, N]
    return vertical_packing.vertical_packing(keys, ggsw, lut_polys_u64)


def _chunk_size(b: int, target: int) -> int:
    """Balanced chunk size <= target: ceil(b / ceil(b/target)).

    Callers pad the batch up to a chunk multiple (waste < one chunk)
    instead of requiring an exact divisor — the old divisor rule collapsed
    to chunk 1 on sizes with no small divisor (a prime byte count meant B
    sequential one-element dispatches).
    """
    if b <= target:
        return b
    nc = -(-b // target)
    return -(-b // nc)


def many_wopbs(keys: DeviceKeys, byte_bits_big: jnp.ndarray,
               lut_polys_u64: jnp.ndarray, *,
               vp_chunk: int = 256) -> jnp.ndarray:
    """Evaluate L LUT output polynomials on a batch of radix "bytes".

    byte_bits_big: [B, nbits, big+1] u64 — nbits 1-bit blocks, LSB first.
    lut_polys_u64: [B or 1, L, C, N]   — per-output LUT polynomials
                   (C > 1 engages the CMux tree when 2^nbits > N).
    Returns [B, L, big+1] u64 — fresh big-LWEs of each output bit, noise
    level NOMINAL (the reference stamps the same, many_wopbs.rs:100-109).

    The CBS blind rotates run at the FULL bit batch (compute-steady from
    ~2048 bits, PERF.md), but the packing-keyswitch / NTT-staging / vertical
    packing tail is chunked over at most `vp_chunk` bytes via lax.map: the
    VP working set ([B, L, C, k+1, N] u64 accumulators plus [P, B, L*C, R, N]
    int32 external-product intermediates) otherwise grows ~linearly with B.
    The reference's dyn-stack scratch discipline
    (many_wopbs.rs:121-157) always fits for the same reason: it sizes the
    hot loop's scratch independently of how many inputs are queued.
    """
    from ..utils import noise_asserts
    if noise_asserts.enabled():     # live sanitizer (utils/noise_asserts):
        # the <=max_noise_level-additions invariant, checked on the REAL
        # ciphertexts entering this bootstrap (noise-asserts parity,
        # Cargo.toml:7)
        noise_asserts.check_big_lwe("wopbs_input", byte_bits_big, "input")
    B, nbits = byte_bits_big.shape[0], byte_bits_big.shape[1]

    def _check_out(out):
        if noise_asserts.enabled():     # fresh-output sigma check
            noise_asserts.check_big_lwe("wopbs_output", out, "fresh")
        return out

    small = extract_bits(keys, byte_bits_big)
    flat = small.reshape(B * nbits, -1)
    bigs = cbs_mod.cbs_pbs_levels(keys, flat)   # [lev, B*nbits, big+1]

    bc = _chunk_size(B, vp_chunk)
    if bc == B:
        return _check_out(_stage_and_pack(keys, bigs, B, nbits,
                                          lut_polys_u64))
    nc = -(-B // bc)
    bpad = nc * bc
    lev = bigs.shape[0]
    np1 = bigs.shape[-1]
    if bpad != B:                               # ragged tail: zero-pad
        bigs = jnp.pad(bigs.reshape(lev, B, nbits, np1),
                       ((0, 0), (0, bpad - B), (0, 0), (0, 0))
                       ).reshape(lev, bpad * nbits, np1)
        if lut_polys_u64.shape[0] != 1:
            lut_polys_u64 = jnp.pad(
                lut_polys_u64,
                ((0, bpad - B),) + ((0, 0),) * (lut_polys_u64.ndim - 1))
    bigs_c = bigs.reshape(lev, nc, bc * nbits, np1).swapaxes(0, 1)
    if lut_polys_u64.shape[0] == 1:             # batch-shared LUT stack
        out = jax.lax.map(
            lambda bg: _stage_and_pack(keys, bg, bc, nbits, lut_polys_u64),
            bigs_c)
    else:                                       # per-batch-element LUTs
        luts_c = lut_polys_u64.reshape((nc, bc) + lut_polys_u64.shape[1:])
        out = jax.lax.map(
            lambda xs: _stage_and_pack(keys, xs[0], bc, nbits, xs[1]),
            (bigs_c, luts_c))
    return _check_out(out.reshape((bpad,) + out.shape[2:])[:B])


# Jitted entry point: compiled once per (key shapes, batch, LUT stack) and
# reused across AES rounds / key-expansion words / CTR ripple steps.  Inlines
# harmlessly when a caller jits a larger region around it.
many_wopbs_jit = jax.jit(many_wopbs, static_argnames=("vp_chunk",))
