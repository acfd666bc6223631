"""Evaluation-key packing: host numpy keys -> device-resident operand layouts.

The reference converts its bootstrap key to the Fourier domain once
(fill_with_forward_fourier, many_wopbs.rs:263) and streams keyswitch keys as
u64; here every key is staged in the layout its consuming kernel wants:

  * BSK   -> per-prime NTT residues of the mod-2^q' ROUNDED key (q' =
             pbs_base_log*pbs_level: the blind rotate runs in a mod-switched
             domain where the gadget decomposition is exact and the RNS basis
             shrinks to `rplan` — 4 big primes at PARAM_OPT instead of the
             mod-2^64 domain's 6; see utils/crt.rotate_primes and
             ops/blind_rotate.py for the noise accounting).  Serialized as
             balanced int16 [n, P, R, k+1, N] (R = (k+1)*pbs_level,
             component-major — matches ops.decompose.glwe_digits_flat);
  * KSK   -> signed 8-bit limbs for the int8 keyswitch matmul
             [big*ks_level, (n+1)*8];
  * PFPKSK-> signed 8-bit limbs for the packing-keyswitch matmul
             [(big+1)*pfks_level, (k+1)_u * (k+1)_j * N * 8].

Total device key material at production parameters ~1 GB (SURVEY.md 2b) —
replicated per chip; CTR blocks are the sharded axis (SURVEY.md 2c).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax

from ..params import ParamSet
from ..utils import crt, torus
from ..backend import numpy_backend as nb
from . import modular, ntt


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceKeys:
    """Evaluation keys as a JAX pytree: array leaves are traced arguments of
    jitted kernels (never baked constants), params/plans are static metadata.

    Two NTT plans: `plan` (mod-2^64 torus domain — CBS GGSW staging and
    vertical packing) and `rplan` (mod-2^q' rotate domain, q' = base^level —
    the blind-rotate hot loop; fewer, bigger primes).  The r-prefixed /
    rotate-only arrays (bsk, rot_table, rfwd_limbs, rinv_crt_limbs) belong
    to rplan."""
    params: ParamSet = dataclasses.field(metadata=dict(static=True))
    plan: ntt.NttPlan = dataclasses.field(metadata=dict(static=True))
    rplan: ntt.NttPlan = dataclasses.field(metadata=dict(static=True))
    bsk_limbs: jax.Array | np.ndarray     # int8  [n, R*2(k+1), Pr*N]
                                          #       prime-MERGED limb row
                                          #       planes
                                          #       (bsk_residues_to_device)
    ksk_limbs: jax.Array | np.ndarray     # int8  [big*ks_lev, (n+1)*8]
    pfpksk_limbs: jax.Array | np.ndarray  # int8  [(big+1)*pfks_lev, (k+1)^2*N*8]
    fwd_limbs: jax.Array | np.ndarray     # int8  [P, 2, 2, N, N]   (64-domain)
    inv_crt_limbs: jax.Array | np.ndarray # int8  [P, 2, 2, N, N]   (64-domain)
    rfwd_limbs: jax.Array | np.ndarray    # int8  [Pr, 2, 2, N, N]  (rotate)
    rinv_crt_limbs: jax.Array | np.ndarray# int8  [Pr, 2, 2, N, N]  (rotate)
    rot_table: jax.Array | np.ndarray     # int16 [2N, Pr*N] merged twiddles


def poly_to_ntt_residues_host(primes, polys_u64: np.ndarray,
                              q_bits: int = 64) -> np.ndarray:
    """mod-2^q_bits polys [..., N] -> balanced NTT residues [P, ..., N] (host).

    Uses the native C++ runtime (multithreaded exact NTT) when available;
    numpy/f64-BLAS fallback otherwise.  The representative is the BALANCED
    one (x - 2^q if x >= 2^(q-1)); for q < 64 the native mod-2^64 residue
    path is reused by scaling x by 2^(64-q) and unscaling the residues.
    """
    from .. import runtime
    n = polys_u64.shape[-1]
    flat = np.ascontiguousarray(polys_u64, dtype=np.uint64).reshape(-1, n)
    if q_bits < 64:
        flat = flat << np.uint64(64 - q_bits)
    outs = []
    for p in primes:
        res = runtime.balanced_residues(flat, p)
        if q_bits < 64:
            inv2 = pow(pow(2, 64 - q_bits, p), p - 2, p)
            res = modular.host_balanced(
                res.astype(np.int64) * inv2, p).astype(np.int32)
        mat, _ = crt.ntt_matrices(p, n)
        outs.append(runtime.ntt_rows_mod(res, mat.astype(np.int32), p)
                    .reshape(polys_u64.shape))
    return np.stack(outs)


def round_to_q(v_u64: np.ndarray, q_bits: int) -> np.ndarray:
    """round(v / 2^(64-q)) mod 2^q — the mod-switch staging the rotate keys.

    The u64 add wraps exactly when the true rounded value would be 2^q = 0
    mod 2^q, so the wrap IS the reduction."""
    if q_bits >= 64:
        return v_u64
    h = np.uint64(1) << np.uint64(63 - q_bits)
    return (v_u64 + h) >> np.uint64(64 - q_bits)


def cancel_mask_rounding(rows_u64: np.ndarray, glwe_key: np.ndarray,
                         q_bits: int) -> np.ndarray:
    """Fold each GLWE row's mask rounding errors into its body (exact).

    rows [..., k+1, N] u64; per row set  b += sum_u e_u (*) S_u  (mod 2^64)
    with e_u = round_to_q(a_u)*2^(64-q) - a_u in +-2^(63-q).  The staged
    row's phase then carries ONLY the body's own +-2^(63-q) rounding:
    without this, the mask errors enter the phase multiplied by the secret
    polynomials S_u (||S||^2 ~ kN/2 = 2^10 at PARAM_OPT — measured to blow
    the GGSW budget at q'=40, see make_rotate_plan).  The convolutions are
    exact: |e| <= 2^(63-q) <= 2^23, S binary, 512-term sums < 2^33 in f64.
    """
    if q_bits >= 64:
        return rows_u64
    from ..backend import numpy_backend as nb
    rows = np.ascontiguousarray(rows_u64, np.uint64).copy()
    k = glwe_key.shape[0]
    s = np.uint64(64 - q_bits)
    lead = rows.shape[:-2]
    adj = np.zeros(lead + rows.shape[-1:], np.float64)
    for u in range(k):
        a = rows[..., u, :]
        e = ((round_to_q(a, q_bits) << s) - a).astype(np.int64)
        mat = nb._negacyclic_matrix(glwe_key[u])        # {-1,0,1} f64
        adj += e.astype(np.float64) @ mat
    rows[..., k, :] += adj.astype(np.int64).astype(np.uint64)
    return rows


def pack_bsk(params: ParamSet, rplan: ntt.NttPlan, bsk_u64: np.ndarray,
             glwe_key: np.ndarray | None = None) -> np.ndarray:
    """Golden BSK [n, lev, k+1(row u), k+1(col j), N] -> NTT int16 layout.

    [n, Pr, R, k+1, N] int16 balanced residues of the mod-2^q' ROUNDED key
    (q' = rplan.q_bits) — the SERIALIZATION format; bsk_residues_to_device
    converts to the device operand layout.  With glwe_key given, each row's
    mask rounding errors are cancelled into its body first
    (cancel_mask_rounding), leaving sigma_round ~ 2^32 at PARAM_OPT — at
    the classic decomposition-rounding floor (NOISE_REPORT.md).
    """
    n_lwe, lev, kp1, _, n = bsk_u64.shape
    # row-major R = u*lev + l
    rows = bsk_u64.transpose(0, 2, 1, 3, 4).reshape(n_lwe, kp1 * lev, kp1, n)
    rows = np.ascontiguousarray(rows, np.uint64)
    if glwe_key is not None:
        rows = cancel_mask_rounding(rows, glwe_key, rplan.q_bits)
    rows = round_to_q(rows, rplan.q_bits)
    res = poly_to_ntt_residues_host(rplan.primes, rows,
                                    rplan.q_bits)       # [P, n, R, k+1, N]
    out = res.transpose(1, 0, 2, 3, 4).astype(np.int16)
    return np.ascontiguousarray(out)


def bsk_residues_to_device(res16: np.ndarray) -> np.ndarray:
    """[n, P, R, k+1, N] int16 residues -> [n, R*2(k+1), P*N] int8 limbs.

    PRIME-MERGED row planes: row r*2(k+1) + j holds output-component j's lo
    limb for j < k+1 (hi limb at j + k+1), with the P primes' residues side
    by side on the minor axis (segment k at k*N..(k+1)*N).  One blind-rotate
    step reads one contiguous [R*2(k+1), P*N] slice.
    """
    n_lwe, pcount, r_rows, kp1, n = res16.shape
    # int16-native limb split (same values as modular.host_balanced_limbs2,
    # which is bounds-asserted and tested): |x| < 2^15.5/2 so x+128 and
    # hi<<8 both stay in int16.  The int64 formulation took ~240 s on the
    # ~514 MB production BSK; this takes ~11 s.
    x = np.ascontiguousarray(res16, dtype=np.int16)
    hi8 = ((x + np.int16(128)) >> np.int16(8)).astype(np.int8)
    lo8 = (x - (hi8.astype(np.int16) << np.int16(8))).astype(np.int8)
    cat = np.concatenate([lo8, hi8], axis=3)           # [n,P,R,2(k+1),N]
    rows = cat.reshape(n_lwe, pcount, r_rows * 2 * kp1, n)
    return np.ascontiguousarray(rows.transpose(0, 2, 1, 3)).reshape(
        n_lwe, r_rows * 2 * kp1, pcount * n)


def pack_ksk(params: ParamSet, ksk_u64: np.ndarray) -> np.ndarray:
    """Golden KSK [big, lev, n+1] -> int8 limbs [big*lev, (n+1)*8]."""
    from .. import runtime
    big, lev, np1 = ksk_u64.shape
    limbs = runtime.signed_limbs(ksk_u64, 8)           # [big, lev, n+1, 8]
    return np.ascontiguousarray(limbs.reshape(big * lev, np1 * 8))


def pack_pfpksk(params: ParamSet, pfpksk_u64: np.ndarray) -> np.ndarray:
    """Golden PFPKSK [k+1, big+1, lev, k+1, N] -> int8 limbs.

    Output [ (big+1)*lev, (k+1)_u * (k+1)_j * N * 8 ] so one matmul applies
    all k+1 functional keyswitches at once (CBS needs all of them per bit).
    """
    from .. import runtime
    kp1, bigp1, lev, _, n = pfpksk_u64.shape
    limbs = runtime.signed_limbs(pfpksk_u64, 8)        # [u, t, l, j, N, 8]
    limbs = limbs.transpose(1, 2, 0, 3, 4, 5)          # [t, l, u, j, N, 8]
    return np.ascontiguousarray(
        limbs.reshape(bigp1 * lev, kp1 * kp1 * n * 8))


def make_rotate_plan(p: ParamSet) -> ntt.NttPlan:
    """The blind-rotate NTT plan: mod-2^48 domain, big-prime RNS (5 primes
    at PARAM_OPT vs the mod-2^64 domain's 6).

    Why 48: the gadget decomposition reads the top base*level <= 40 bits,
    so any q' >= 40 is lossless for it, and SMALLER q' means fewer CRT
    primes — but the BSK must be rounded to q' bits at staging, and its
    rounding noise is consumed by circuit bootstrapping whose GGSW outputs
    vertical packing amplifies by ~2^19 (cbs_base 2^15 digits x sqrt(8N/3)).
    The budget there is sigma_ggsw <= 2^39.5; measurement at q'=40 gave
    sigma ~ 2^45 (mask-rounding errors amplified by ||S||) — broken — while
    q'=48 with mask-error cancellation (pack_bsk folds each row's mask
    rounding errors into its body, cancelling them in the phase exactly)
    measures at the classic decomposition-rounding floor.  q' in (41, 47]
    buys nothing: the CRT range 2*R*N*2^(blog-1)*2^(q-1) needs the 5th
    prime from q'=42 up, and 4 primes cap at q'=40 whose noise fails."""
    q = max(48, p.pbs_base_log * p.pbs_level)
    primes = crt.rotate_primes(q, p.polynomial_size, p.pbs_base_log,
                               p.glwe_dimension, p.pbs_level)
    return ntt.make_plan(p.polynomial_size, primes, q_bits=q)


def make_device_keys(sk: nb.SecretKeys, rng: np.random.Generator,
                     primes=None) -> DeviceKeys:
    """Generate (numpy golden) + pack all evaluation keys for the device."""
    p = sk.params
    plan = ntt.make_plan(p.polynomial_size, primes or crt.ntt_primes())
    rplan = make_rotate_plan(p)
    bsk = nb.bsk_gen(sk, rng)
    ksk = nb.ksk_gen(sk, rng)
    pfp = nb.pfpksk_gen(sk, rng)
    return DeviceKeys(
        params=p,
        plan=plan,
        rplan=rplan,
        bsk_limbs=bsk_residues_to_device(
            pack_bsk(p, rplan, bsk, glwe_key=sk.glwe_key)),
        ksk_limbs=pack_ksk(p, ksk),
        pfpksk_limbs=pack_pfpksk(p, pfp),
        fwd_limbs=plan.fwd_limbs,
        inv_crt_limbs=plan.inv_crt_limbs,
        rfwd_limbs=rplan.fwd_limbs,
        rinv_crt_limbs=rplan.inv_crt_limbs,
        rot_table=ntt.rot_table_merged(rplan),
    )


def device_keys_shapes(params: ParamSet) -> DeviceKeys:
    """DeviceKeys with ShapeDtypeStruct KEY leaves and real constant tables.

    For ahead-of-time compile warm-up (utils/warmup.py): jit.lower() only
    needs avals for the key material, and the plan-derived tables (NTT
    matrices, twiddles) are key-independent and cheap, so the production
    programs can be compiled before a single key bit exists — overlapping
    the cold-start compiles with key generation.  The
    lowered HLO is identical to the real call's (every leaf is a traced
    argument, never a baked constant), so the jit/persistent caches hit.
    """
    import jax.numpy as jnp
    p = params
    plan = ntt.make_plan(p.polynomial_size, crt.ntt_primes())
    rplan = make_rotate_plan(p)
    k, n = p.glwe_dimension, p.polynomial_size
    kp1 = k + 1
    r_rows = kp1 * p.pbs_level
    sds = jax.ShapeDtypeStruct
    return DeviceKeys(
        params=p, plan=plan, rplan=rplan,
        bsk_limbs=sds((p.lwe_dimension, r_rows * 2 * kp1,
                       rplan.n_primes * n),
                      jnp.int8),
        ksk_limbs=sds((p.big_lwe_dimension * p.ks_level,
                       (p.lwe_dimension + 1) * 8), jnp.int8),
        pfpksk_limbs=sds(((p.big_lwe_dimension + 1) * p.pfks_level,
                          kp1 * kp1 * n * 8), jnp.int8),
        fwd_limbs=plan.fwd_limbs,
        inv_crt_limbs=plan.inv_crt_limbs,
        rfwd_limbs=rplan.fwd_limbs,
        rinv_crt_limbs=rplan.inv_crt_limbs,
        rot_table=ntt.rot_table_merged(rplan),
    )
