"""Batched blind rotation — the hot loop.

Computes, for a batch of LWE ciphertexts, the classic TFHE accumulator loop
(acc = X^-b~ * v;  acc = CMux(BSK_i, acc, X^a~_i * acc)) with every step's
external product expressed as int8 x int8 -> int32 matmuls (ops/ntt.py).  The batch axis
is the whole design: the reference bootstraps the 128 state bits of an AES
round one at a time on CPU threads (SURVEY.md 3.2); here they ride one fused
batch through the n sequential CMux steps.

Two reformulations (both exact-by-construction; decryption is verified
bit-exact against the plaintext oracle):

1. Rotation as post-MAC NTT twiddles.  Instead of decomposing the rotated
   difference  G^-1(X^a * acc - acc)  — a per-element coefficient-domain
   gather over the whole batch on every step — each step computes

       acc += (X^a - 1) * (G^-1(acc) (x) BSK_i)

   Rotation commutes with the external product, so the monomial is applied
   AFTER the MAC, in the NTT domain, as a pointwise multiply by
   psi^(a*(2j+1)) (plan.rot_table).  Functionally identical to the classic
   CMux (golden model nb.blind_rotate); the only difference is the noise
   term: the BSK noise enters as (X^a - 1)*E — variance 2x per step — far
   below the f64-FFT rounding noise the reference's parameter optimization
   already budgets for (its tfhe-fft c64 path, many_wopbs.rs:263) and which
   our exact NTT eliminates.

2. The accumulator lives mod q' = 2^48 (ops/keys.make_rotate_plan), not
   mod 2^64.  The gadget decomposition reads only the top base*level <= 40
   bits of the accumulator, so the mod-q' loop is lossless for it — and
   the exact-CRT range shrinks from 2^84.6 to 2^68.6, which 5 big primes
   cover instead of 6 (utils/crt.rotate_primes): 1/6 fewer NTT matmuls and
   ~35% less elementwise CRT work per step (the byte chains go 8x6 -> 6x5).
   Noise accounting for the mod-switch artifacts (2^64 scale, against the
   GGSW-consumption budget sigma <= ~2^39.5 — vertical packing amplifies
   GGSW noise by cbs-digit x sqrt(8N/3) ~ 2^19 before the 2^62 decrypt
   threshold; measured totals in NOISE_REPORT.md):
     a. the input accumulator is rounded once to q' bits: uniform error
        <= 2^(63-q') = 2^15 (vs the 2^23 PER-STEP gadget rounding that is
        still there at shift 48-40=8 — unchanged from the classic design);
     b. the BSK is rounded once to q' bits at staging, with each row's
        mask rounding errors cancelled into its body (keys.
        cancel_mask_rounding — without that the errors ride the phase
        multiplied by ||S|| ~ 2^5 and measured sigma ~ 2^45 at q'=40,
        which BROKE WoPBS; the q'=40 / 4-prime design is unreachable for
        this reason).  Residual body-only rounding accumulates
        sigma ~ 2^32.4 over 669 steps — at the decomposition-rounding
        floor, 7 bits inside the GGSW budget;
     c. the output is scaled back by 2^(64-q'), quantizing output noise
        to multiples of 2^16 — bounded by a.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..params import ParamSet
from . import decompose, lwe, modular, ntt

U64 = jnp.uint64


def external_product_ntt(plan: ntt.NttPlan, diff_u64: jnp.ndarray,
                         ggsw_ntt_i32: jnp.ndarray, base_log: int,
                         levels: int, fwd_limbs, inv_crt_limbs
                         ) -> jnp.ndarray:
    """GGSW (NTT residues) x GLWE-delta (u64) -> GLWE (u64).

    diff_u64: [B, F..., k+1, N] against per-batch GGSW
    ggsw_ntt_i32 [P, B, R, k+1, N] (vertical packing: each byte's selector
    bit, broadcast over its LUT/chunk axes).  Returns diff's shape.
    """
    digits = decompose.glwe_digits_flat(diff_u64, base_log, levels)
    if base_log <= 8:
        dhat = ntt.ntt_fwd_digits(plan, digits.astype(jnp.int8), fwd_limbs)
    else:
        dhat = ntt.ntt_fwd_wide(plan, digits, fwd_limbs)
    P = dhat.shape[0]
    lead = dhat.shape[1:-2]                       # diff's batch axes
    r, n = dhat.shape[-2], dhat.shape[-1]
    b = ggsw_ntt_i32.shape[1]
    dh = dhat.reshape(P, b, -1, r, n)
    prod = ntt.mac_batched(plan, dh, ggsw_ntt_i32)
    kp1 = ggsw_ntt_i32.shape[-2]
    prod = prod.reshape((P,) + lead + (kp1, n))
    return ntt.intt_crt_u64(plan, prod, inv_crt_limbs)


def blind_rotate(plan: ntt.NttPlan, params: ParamSet, bsk_limbs: jnp.ndarray,
                 lwe_u64: jnp.ndarray, test_glwe_u64: jnp.ndarray,
                 fwd_limbs: jnp.ndarray, inv_crt_limbs: jnp.ndarray,
                 rot_table: jnp.ndarray) -> jnp.ndarray:
    """lwe_u64: [B, n+1]; test_glwe_u64: [k+1, N] or [B, k+1, N].

    Returns acc [B, k+1, N] u64 encrypting X^(-phase~) * test.  `plan` is
    the rotate plan (plan.q_bits = pbs_base_log * pbs_level); the loop runs
    mod 2^q_bits and the result is scaled back to the 2^64 torus.
    """
    n_poly = params.polynomial_size
    two_n = 2 * n_poly
    kp1 = params.glwe_dimension + 1
    q = plan.q_bits
    assert params.pbs_base_log * params.pbs_level <= q <= 64
    tilde = lwe.modswitch(lwe_u64, two_n)            # [B, n+1] int32
    b_t = tilde[:, -1]
    if test_glwe_u64.ndim == 2:
        test_glwe_u64 = jnp.broadcast_to(
            test_glwe_u64[None], (lwe_u64.shape[0],) + test_glwe_u64.shape)
    acc0 = lwe.neg_rotate(test_glwe_u64, ((two_n - b_t) % two_n)[:, None])
    if q < 64:                                       # mod-switch once
        acc0 = (acc0 + (U64(1) << U64(63 - q))) >> U64(64 - q)
    base_log, levels = params.pbs_base_log, params.pbs_level
    p_c, inv_c, _ = ntt._prime_consts(plan, 4)       # [P,1,1,1] broadcasts

    def body(i, acc):
        digits = decompose.glwe_digits_flat(acc, base_log, levels, q)
        if base_log <= 8:
            dhat = ntt.ntt_fwd_digits(plan, digits.astype(jnp.int8),
                                      fwd_limbs)
        else:   # wide digits (e.g. PARAM_TPU's 12-bit base): 2-limb NTT
            dhat = ntt.ntt_fwd_wide(plan, digits, fwd_limbs)
        dl, dh = modular.to_balanced_limbs2(dhat)    # [P, B, R, N] int8
        g_m = jax.lax.dynamic_index_in_dim(bsk_limbs, i, axis=0,
                                           keepdims=False)  # [R*2J, P*N]
        g = jnp.transpose(g_m.reshape(g_m.shape[0], plan.n_primes, n_poly),
                          (1, 0, 2))                 # [P, R*2J, N]
        prod = ntt.mac_rows(plan, dl, dh, g, kp1)    # [P, B, J, N]
        a_i = tilde[:, i]                            # [B]
        tw_m = jnp.take(rot_table, a_i, axis=0)      # [B, P*N] merged i16
        tw = jnp.transpose(
            tw_m.astype(jnp.int32).reshape(-1, plan.n_primes, n_poly),
            (1, 0, 2))                               # [P, B, N]
        delta_hat = ntt.barrett_rotate_delta(plan, prod, tw, p_c, inv_c)
        delta = ntt.intt_crt_u64(plan, delta_hat, inv_crt_limbs)
        acc = acc + delta                            # intt masked mod 2^q
        if q < 64:
            acc = acc & U64((1 << q) - 1)
        return acc

    acc = jax.lax.fori_loop(0, params.lwe_dimension, body, acc0)
    return acc << U64(64 - q) if q < 64 else acc
