"""Batched LWE keyswitch (big -> small) as one int8 matmul mod 2^64.

The reference's extract-bits step costs one keyswitch per state bit
(many_wopbs.rs:194-199 with 1-bit blocks, SURVEY.md 2b); batching every bit of
every byte of every block makes it a single [B, big*lev] @ [big*lev, (n+1)*8]
int8 matmul whose int32 limb sums are recombined mod 2^64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import ParamSet
from . import decompose

U64 = jnp.uint64


def limb_matmul_u64(digits_i8: jnp.ndarray, key_limbs_i8: jnp.ndarray,
                    out_cols: int) -> jnp.ndarray:
    """[B, T] int8 @ [T, out_cols*8] int8 -> u64 [B, out_cols].

    Accumulation bound: T * 128 * 128 must stay < 2^31 (holds for all key
    sizes here: T <= 2048*6 -> < 2^27.6 worst case with 2-bit digits).
    Recombination sum_l m_l * 2^(8l) runs in u64 (wraps mod 2^64).
    """
    m = jax.lax.dot_general(digits_i8, key_limbs_i8,
                            (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    m = m.reshape(m.shape[:-1] + (out_cols, 8))
    out = jnp.zeros(m.shape[:-1], U64)
    for l in range(8):
        term = m[..., l].astype(jnp.int64).astype(U64) << U64(8 * l)
        out = out + term
    return out


def keyswitch(params: ParamSet, ksk_limbs: jnp.ndarray,
              ct_u64: jnp.ndarray) -> jnp.ndarray:
    """ct [..., big+1] u64 under the big key -> [..., n+1] under the small key."""
    a, b = ct_u64[..., :-1], ct_u64[..., -1]
    d = decompose.gadget_decompose(a, params.ks_base_log, params.ks_level)
    sh = d.shape
    d = d.reshape(sh[:-2] + (sh[-2] * sh[-1],)).astype(jnp.int8)  # [..., T]
    lead = d.shape[:-1]
    ks = limb_matmul_u64(d.reshape(-1, d.shape[-1]), ksk_limbs,
                         params.lwe_dimension + 1)
    ks = ks.reshape(lead + (params.lwe_dimension + 1,))
    out = jnp.zeros(lead + (params.lwe_dimension + 1,), U64)
    out = out.at[..., -1].set(b)
    return out - ks
