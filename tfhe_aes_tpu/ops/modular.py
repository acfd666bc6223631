"""Device-side exact modular arithmetic for the RNS/NTT pipeline.

Everything is engineered so that 32-bit-and-narrower dtypes suffice:

  * residues mod p are kept *balanced* (in [-(p-1)/2, (p-1)/2]) so they fit
    int16 storage and two signed 8-bit limbs — the operands of the int8 x
    int8 -> int32 matrix products;
  * p < 2^15.5 (see utils/crt.py) so any product of two balanced residues is
    < 2^30 in magnitude and fits a signed int32;
  * reduction is a Barrett step with an f32 reciprocal: the quotient estimate
    is off by at most 1, fixed by conditional subtracts — exact, no 64-bit
    arithmetic anywhere.

This replaces the reference's approximate c64 FFT arithmetic
(the reference's src/server/sbox/many_wopbs.rs:22,64) with exact integer math,
so every device result is bit-exact against the numpy golden model.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def barrett_reduce(t: jnp.ndarray, p, inv_p) -> jnp.ndarray:
    """Balanced reduction mod p of int32 t with |t| < ~2^30.9.

    q = round(t/p) estimated via f32; the estimate is within 1 of truth
    (|t| < 2^31 -> f32 conversion error < 2^7, times 1/p < 2^-13.5 -> < 2^-6),
    so r = t - q*p lies in (-3p/2, 3p/2); one conditional +-p lands it in
    [-p/2, p/2].  All int32/f32 ops.
    """
    q = jnp.round(t.astype(jnp.float32) * inv_p).astype(jnp.int32)
    r = t - q * p
    half = (p - 1) // 2
    r = jnp.where(r > half, r - p, r)
    r = jnp.where(r < -half, r + p, r)
    return r


def to_balanced_limbs2(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split balanced residues (|x| <= p/2 < 2^15) into two signed 8-bit limbs.

    x = lo + 256*hi with lo in [-128, 127], hi in [-91, 91] (for p < 2^15.5).
    """
    hi = (x + 128) >> 8
    lo = x - (hi << 8)
    return lo.astype(jnp.int8), hi.astype(jnp.int8)


def host_balanced(x: np.ndarray, p: int) -> np.ndarray:
    """Host: canonical residues [0,p) -> balanced [-(p-1)/2, (p-1)/2]."""
    x = np.asarray(x) % p
    return np.where(x > p // 2, x - p, x).astype(np.int64)


def host_balanced_limbs2(x: np.ndarray) -> np.ndarray:
    """Host version of to_balanced_limbs2 -> int8 [..., 2]."""
    x = np.asarray(x, dtype=np.int64)
    hi = (x + 128) >> 8
    lo = x - (hi << 8)
    assert lo.min() >= -128 and lo.max() <= 127
    assert hi.min() >= -128 and hi.max() <= 127
    return np.stack([lo, hi], axis=-1).astype(np.int8)
