"""Vertical packing on device: batched multi-LUT evaluation from GGSW bits.

The signature trick of the reference (many_wopbs.rs:28-30): one circuit
bootstrap per selector bit, then *many* LUT polynomials ride the same GGSW
list through CMux blind rotation.  Here that amortization is a tensor axis:
all LUT output polynomials (e.g. 3 LUTs x 8 output bits = 24 for the fused
S-box, sbox.rs:68-97) sit on one accumulator batch axis and every CMux step
is a single batched external product against the per-byte GGSW.

Rotations by +-2^j are static (roll + sign), so the only per-element gathers
in the whole WoPBS pipeline are the blind-rotate data rotations.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import blind_rotate, lwe
from .keys import DeviceKeys

U64 = jnp.uint64


def vertical_packing(keys: DeviceKeys, ggsw_ntt: jnp.ndarray,
                     lut_polys_u64: jnp.ndarray) -> jnp.ndarray:
    """Evaluate LUTs under GGSW-encrypted selector bits.

    ggsw_ntt:      [nbits, P, B, R2, k+1, N] int32 (bit j at index j, LSB
                   first; each encrypts bit j of the byte batch B).
    lut_polys_u64: [B or 1, L, C, N] u64 — L parallel output polynomials per
                   batch element, C = 2^tree_bits chunk polys each (C=1 when
                   2^nbits <= N).
    Returns big-LWE [B, L, big+1] u64 of lut[value] per (batch, output).
    """
    plan, p = keys.plan, keys.params
    nbits = ggsw_ntt.shape[0]
    n = p.polynomial_size
    log_n = p.log2_poly_size
    n_rot = min(nbits, log_n)
    tree_bits = nbits - n_rot
    B = ggsw_ntt.shape[2]
    L = lut_polys_u64.shape[1]
    C = lut_polys_u64.shape[2]
    assert C == 1 << tree_bits

    fwd = keys.fwd_limbs
    inv_crt = keys.inv_crt_limbs

    # Trivial GLWE accumulators [B, L, C, k+1, N].
    acc = jnp.zeros((B, L, C, p.glwe_dimension + 1, n), U64)
    acc = acc.at[..., -1, :].set(
        jnp.broadcast_to(lut_polys_u64, (B, L, C, n)))

    def step(acc_flat, g_bit, rotated):
        """One CMux layer: acc <- acc + G x (rotated - acc)."""
        diff = rotated - acc_flat
        # g_bit: [P, B, R2, k+1, N] — per-byte GGSW, broadcast over L (and C).
        return acc_flat + blind_rotate.external_product_ntt(
            plan, diff, g_bit, p.cbs_base_log, p.cbs_level, fwd, inv_crt)

    # CMux tree over high bits (MSB-most): halves the chunk axis per layer.
    for t in range(tree_bits):
        g = ggsw_ntt[n_rot + t]
        acc = step(acc[:, :, 0::2], g, acc[:, :, 1::2])
    acc = acc[:, :, 0]                                  # [B, L, k+1, N]

    # Blind rotation over low bits: bit j selects rotation X^(-2^j).
    for j in range(n_rot):
        rot = lwe.neg_rotate_const(acc, 2 * n - (1 << j))
        diff = rot - acc
        acc = acc + blind_rotate.external_product_ntt(
            plan, diff, ggsw_ntt[j], p.cbs_base_log, p.cbs_level, fwd,
            inv_crt)
    return lwe.sample_extract0(acc)
