"""Circuit bootstrap on device: bit LWE -> GGSW (NTT-ready), batched.

Pipeline per batch of extracted bits (reference semantics at
many_wopbs.rs:245-264 -> tfhe-rs circuit_bootstrap_boolean):
  per cbs level l: boolean PBS to b * 2^(64 - cbs_base*(l+1)) (blind rotate
  with a constant test polynomial + half-box offset), then one int8 matmul
  applies all k+1 private functional packing keyswitches, yielding the
  GGSW's level-l rows; finally the rows are NTT-transformed once (the
  fill_with_forward_fourier analog) so vertical packing can consume them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import ParamSet
from . import blind_rotate, decompose, lwe, ntt
from .keys import DeviceKeys

U64 = jnp.uint64


def pbs_boolean(keys: DeviceKeys, lwe_small_u64: jnp.ndarray,
                out_scale_log: int) -> jnp.ndarray:
    """[B, n+1] bit at delta 2^63 -> [B, big+1] of bit * 2^out_scale_log."""
    p = keys.params
    ct = lwe_small_u64.at[..., -1].add(U64(1) << U64(62))
    n = p.polynomial_size
    test = jnp.zeros((p.glwe_dimension + 1, n), U64)
    test = test.at[-1, :].set(U64(0) - (U64(1) << U64(out_scale_log - 1)))
    acc = blind_rotate.blind_rotate(keys.rplan, p, keys.bsk_limbs, ct, test,
                                    keys.rfwd_limbs, keys.rinv_crt_limbs,
                                    keys.rot_table)
    out = lwe.sample_extract0(acc)
    return out.at[..., -1].add(U64(1) << U64(out_scale_log - 1))


def pfpksk_apply_all(keys: DeviceKeys, big_lwe_u64: jnp.ndarray) -> jnp.ndarray:
    """Apply all k+1 packing keyswitches: [B, big+1] -> [B, k+1_u, k+1_j, N].

    12-bit digits are split into two int8 limbs; two int8 matmuls against the
    pre-limbed key then recombine mod 2^64.
    """
    p = keys.params
    kp1, n = p.glwe_dimension + 1, p.polynomial_size
    d = decompose.gadget_decompose(big_lwe_u64, p.pfks_base_log, p.pfks_level)
    sh = d.shape
    d = d.reshape(sh[:-2] + (sh[-2] * sh[-1],))      # [B, T2] int32 12-bit
    hi = (d + 128) >> 8
    lo = (d - (hi << 8)).astype(jnp.int8)
    hi = hi.astype(jnp.int8)
    key = keys.pfpksk_limbs                          # [T2, kp1*kp1*N*8]
    out_cols = kp1 * kp1 * n
    outs = []
    for i, dl in enumerate((lo, hi)):
        m = jax.lax.dot_general(dl, key, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
        m = m.reshape(m.shape[:-1] + (out_cols, 8))
        acc = jnp.zeros(m.shape[:-1], U64)
        for l in range(8):
            if 8 * l + 8 * i >= 64:
                continue  # term is 0 mod 2^64; shift-by-64 is UB-adjacent
            acc = acc + ((m[..., l].astype(jnp.int64).astype(U64))
                         << U64(8 * l + 8 * i))
        outs.append(acc)
    out = outs[0] + outs[1]
    return out.reshape(out.shape[:-1] + (kp1, kp1, n))


def cbs_pbs_levels(keys: DeviceKeys,
                   lwe_small_u64: jnp.ndarray) -> jnp.ndarray:
    """The PBS half of circuit bootstrap: [B, n+1] -> [cbs_level, B, big+1].

    Kept separate from the packing/staging tail so callers can run the
    blind rotates at the FULL batch (they are compute-steady from ~2048
    bits) while chunking the memory-heavy tail (ops/wopbs.many_wopbs)."""
    p = keys.params
    return jnp.stack([
        pbs_boolean(keys, lwe_small_u64, 64 - p.cbs_base_log * (l + 1))
        for l in range(p.cbs_level)])


def cbs_stage_ggsw(keys: DeviceKeys, bigs: jnp.ndarray) -> jnp.ndarray:
    """Packing keyswitch + NTT staging: [lev, B, big+1] -> GGSW residues.

    Returns [P, B, R2, k+1, N] int32, R2 = (k+1) * cbs_level,
    component-major (u*cbs_level + l) — matching decompose.glwe_digits_flat
    for the vertical-packing external products.
    """
    p = keys.params
    plan = keys.plan
    rows = [pfpksk_apply_all(keys, bigs[l])          # [B, u, j, N] u64
            for l in range(p.cbs_level)]
    g = jnp.stack(rows, axis=2)                      # [B, u, lev, j, N]
    sh = g.shape
    g = g.reshape(sh[0], sh[1] * sh[2], sh[3], sh[4])  # [B, R2, j, N]
    res = ntt.u64_to_residues(plan, g)               # [P, B, R2, j, N] bal
    return ntt.ntt_fwd_residues(plan, res, keys.fwd_limbs)


def circuit_bootstrap(keys: DeviceKeys,
                      lwe_small_u64: jnp.ndarray) -> jnp.ndarray:
    """[B, n+1] bit -> GGSW NTT residues [P, B, R2, k+1, N] int32."""
    return cbs_stage_ggsw(keys, cbs_pbs_levels(keys, lwe_small_u64))
