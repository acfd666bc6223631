"""Negacyclic NTT: exact u64 polynomial products via RNS + int8 matmuls.

Replaces the reference's tfhe-fft f64 FFT (many_wopbs.rs:64,263) with an exact
residue-number-system transform built from integer matrix products:

  * the transform itself is a matmul by precomputed twiddle matrices, staged
    as signed 8-bit limbs -> int8 x int8 -> int32 dots;
  * per-prime reductions are f32-Barrett steps (ops/modular.py);
  * the inverse transform folds n^-1 and the explicit-CRT premultiplier c_k
    into the matrices, so CRT reconstruction mod 2^64 needs only u64
    multiply-adds by per-prime constants.

Matmul NTT is O(N^2), but at N = 512 it is dense int8 matrix work that the
accelerator's integer matrix units run, instead of a butterfly network of
64-bit modular multiplies (SURVEY.md section 7, item 2).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import crt
from . import modular

I32 = jnp.int32


def _host_limb_matrices(primes, n: int, inverse: bool, fold_crt: bool):
    """Precompute twiddle matrices as int8 limbs.

    Returns int8 array [P, n_scale=2, n_limb=2, N, N]:
      scale index i corresponds to input limb i (matrix pre-scaled by 2^(8i)),
      limb index j is the output 8-bit limb of the balanced matrix entries.
    """
    cst = crt.crt_constants(tuple(primes))
    mats = []
    for k, p in enumerate(primes):
        fwd, inv = crt.ntt_matrices(p, n)
        m = inv if inverse else fwd
        if fold_crt:
            m = (m * int(cst["c"][k])) % p
        per_scale = []
        for i in range(2):
            scaled = (m * pow(2, 8 * i, p)) % p
            bal = modular.host_balanced(scaled, p)
            per_scale.append(modular.host_balanced_limbs2(bal))  # [N,N,2]
        mats.append(np.stack(per_scale))  # [2, N, N, 2]
    arr = np.stack(mats)  # [P, 2, N, N, 2]
    return np.ascontiguousarray(arr.transpose(0, 1, 4, 2, 3))  # [P,2,2,N,N]


@dataclasses.dataclass(frozen=True, eq=False)
class NttPlan:
    """Precomputed device constants for one polynomial size.

    eq=False: hashed/compared by identity so the plan can ride jitted
    functions as static metadata (make_plan is cached, so identity is stable
    per (n, primes)).  The big limb matrices must NOT be read inside traced
    code — pass them as explicit array arguments (see ops.keys.DeviceKeys).
    """
    n: int
    primes: tuple[int, ...]
    q_bits: int                  # accumulator modulus 2^q_bits (64 or B^lev)
    fwd_limbs: np.ndarray        # int8 [P, 2, 2, N, N]
    inv_limbs: np.ndarray        # int8 [P, 2, 2, N, N]  (n^-1 folded)
    inv_crt_limbs: np.ndarray    # int8 [P, 2, 2, N, N]  (n^-1 and c_k folded)
    p_i32: np.ndarray            # int32 [P]
    inv_f32: np.ndarray          # float32 [P]
    mk64: np.ndarray             # uint64 [P]   (M/p_k mod 2^64)
    m64: np.uint64               # M mod 2^64
    fp: np.ndarray               # int64 [P]    floor(2^40 / p_k)
    fp_shift: int
    pow2_8i: np.ndarray          # int32 [P, 8] balanced (2^(8i) mod p_k)
    rot_table: np.ndarray        # int32 [P, 2N, N] balanced psi^(a*(2j+1))

    @property
    def n_primes(self) -> int:
        return len(self.primes)


def _host_rot_table(primes, n: int) -> np.ndarray:
    """rot_table[p, a, j] = balanced(psi^(a*(2j+1)) mod p), a in [0, 2N).

    In the negacyclic NTT (evaluation at x_j = psi^(2j+1)) multiplication by
    the monomial X^a is the pointwise multiply by x_j^a — so a blind-rotate
    CMux rotation becomes one row-gather from this table plus an elementwise
    multiply, instead of a per-element coefficient-domain gather over the
    whole batch.
    """
    j = np.arange(n, dtype=np.int64)
    a = np.arange(2 * n, dtype=np.int64)[:, None]
    e = (a * (2 * j + 1)) % (2 * n)                       # [2N, N]
    out = []
    for p in primes:
        psi = crt.root_of_unity(p, 2 * n)
        pows = np.array([pow(psi, int(t), p) for t in range(2 * n)],
                        dtype=np.int64)
        out.append(modular.host_balanced(pows[e], p))
    return np.stack(out).astype(np.int32)


_plan_lock = __import__("threading").Lock()


def make_plan(n: int, primes: tuple[int, ...] | None = None,
              q_bits: int = 64) -> NttPlan:
    """Identity-stable plan constructor (cached).

    The lock matters: plans hash by IDENTITY as jit static fields, so two
    threads racing the cache miss (e.g. the AOT compile warm-up vs keygen,
    utils/warmup.py) would each get a distinct plan object and every
    program would silently recompile — exactly the cold-start cost the
    warm-up exists to hide (round-5 root cause).
    """
    with _plan_lock:
        return _make_plan(n, primes, q_bits)


@functools.lru_cache(maxsize=None)
def _make_plan(n: int, primes: tuple[int, ...] | None = None,
               q_bits: int = 64) -> NttPlan:
    primes = primes or crt.ntt_primes()
    cst = crt.crt_constants(tuple(primes), q_bits)
    pow2 = np.stack([
        modular.host_balanced([pow(2, 8 * i, p) for i in range(8)], p)
        for p in primes]).astype(np.int32)
    return NttPlan(
        n=n,
        primes=tuple(primes),
        q_bits=q_bits,
        fwd_limbs=_host_limb_matrices(primes, n, inverse=False, fold_crt=False),
        inv_limbs=_host_limb_matrices(primes, n, inverse=True, fold_crt=False),
        inv_crt_limbs=_host_limb_matrices(primes, n, inverse=True,
                                          fold_crt=True),
        p_i32=np.array(primes, dtype=np.int32),
        inv_f32=(1.0 / np.array(primes, np.float64)).astype(np.float32),
        mk64=cst["mk64"],
        m64=cst["m64"],
        fp=cst["fp"],
        fp_shift=cst["fp_shift"],
        pow2_8i=pow2,
        rot_table=_host_rot_table(primes, n),
    )


def _apply_limb_matrices(x_limbs: list[jnp.ndarray], mats: jnp.ndarray,
                         k: int, p, inv_p) -> jnp.ndarray:
    """sum_i x_i @ (2^(8i) * M) for one prime; returns balanced int32 [..,N].

    x_limbs[i]: int8 [..., N]; mats: int8 [P, 2, 2, N, N].
    Per input limb: |x_i @ M_lo| <= N*128*128 < 2^23 and
    |x_i @ M_hi|*256 <= N*128*91*256 < 2^30.6 -> int32-safe, one Barrett each.
    """
    shape = x_limbs[0].shape
    acc = None
    for i, xi in enumerate(x_limbs):
        x2 = xi.reshape(-1, shape[-1])
        lo = jax.lax.dot_general(x2, mats[k, i, 0],
                                 (((1,), (0,)), ((), ())),
                                 preferred_element_type=I32)
        hi = jax.lax.dot_general(x2, mats[k, i, 1],
                                 (((1,), (0,)), ((), ())),
                                 preferred_element_type=I32)
        term = modular.barrett_reduce(lo + (hi << 8), p, inv_p)
        acc = term if acc is None else acc + term
    if len(x_limbs) > 1:
        acc = modular.barrett_reduce(acc, p, inv_p)
    return acc.reshape(shape)


def ntt_fwd_digits(plan: NttPlan, digits_i8: jnp.ndarray,
                   fwd_limbs: jnp.ndarray) -> jnp.ndarray:
    """Forward NTT of int8 gadget digits -> balanced int32 [P, ..., N]."""
    outs = []
    for k in range(plan.n_primes):
        outs.append(_apply_limb_matrices([digits_i8], fwd_limbs, k,
                                         int(plan.p_i32[k]),
                                         float(plan.inv_f32[k])))
    return jnp.stack(outs)


def split2(x: jnp.ndarray) -> list[jnp.ndarray]:
    """Balanced int32 (|x| <= ~2^15) -> two int8 limbs [lo, hi]."""
    hi = (x + 128) >> 8
    lo = x - (hi << 8)
    return [lo.astype(jnp.int8), hi.astype(jnp.int8)]


def ntt_fwd_wide(plan: NttPlan, vals_i32: jnp.ndarray,
                 fwd_limbs: jnp.ndarray) -> jnp.ndarray:
    """Forward NTT of balanced values |v| < 2^15 (e.g. 15-bit CBS digits)."""
    limbs = split2(vals_i32)
    outs = []
    for k in range(plan.n_primes):
        outs.append(_apply_limb_matrices(limbs, fwd_limbs, k,
                                         int(plan.p_i32[k]),
                                         float(plan.inv_f32[k])))
    return jnp.stack(outs)


def ntt_fwd_residues(plan: NttPlan, res: jnp.ndarray,
                     fwd_limbs: jnp.ndarray) -> jnp.ndarray:
    """Forward NTT of per-prime balanced residues [P, ..., N] (|.| <= p/2).

    Used to stage freshly produced GGSW rows (CBS output) in the NTT domain —
    the analog of the reference's fill_with_forward_fourier
    (many_wopbs.rs:263).
    """
    outs = []
    for k in range(plan.n_primes):
        outs.append(_apply_limb_matrices(split2(res[k]), fwd_limbs, k,
                                         int(plan.p_i32[k]),
                                         float(plan.inv_f32[k])))
    return jnp.stack(outs)


def _prime_consts(plan: NttPlan, rank: int):
    """Per-prime constant vectors shaped [P, 1, 1, ...] for broadcasting."""
    sh = (plan.n_primes,) + (1,) * (rank - 1)
    p = jnp.asarray(plan.p_i32).reshape(sh)
    inv = jnp.asarray(plan.inv_f32).reshape(sh)
    c16 = jnp.asarray(np.stack([
        modular.host_balanced(1 << 16, int(q)) for q in plan.primes]
    ).astype(np.int32)).reshape(sh)
    return p, inv, c16


def _combine_limb_dots(plan: NttPlan, s_ll, s_mid, s_hh) -> jnp.ndarray:
    """Recombine limb-product dot sums: value = s_ll + 2^8 s_mid + 2^16 s_hh.

    Each partial sum is < 2^20 (R <= 25 terms of int8 x int8 products), so
    the shifted terms are reduced mod p BEFORE scaling — everything stays
    int32-exact.  Returns balanced residues.
    """
    p, inv, c16 = _prime_consts(plan, s_ll.ndim)
    r_mid = modular.barrett_reduce(s_mid, p, inv)
    r_mid = modular.barrett_reduce(r_mid * 256, p, inv)
    r_hh = modular.barrett_reduce(s_hh, p, inv)
    r_hh = modular.barrett_reduce(r_hh * c16, p, inv)
    return modular.barrett_reduce(s_ll + r_mid + r_hh, p, inv)


def mac_shared(plan: NttPlan, dhat: jnp.ndarray,
               ghat: jnp.ndarray) -> jnp.ndarray:
    """out[p,m,j,n] = sum_r dhat[p,m,r,n] * ghat[p,r,j,n] (balanced mod p_k).

    dhat: balanced int32 [P, M, R, N]; ghat: balanced int [P, R, J, N]
    shared by every batch row m (keygen's mask products: one secret key,
    many masks).  The elementwise limb MAC of mac_batched with one batch
    element: R = k is 2-4 here, and XLA:GPU (JAX 0.9.0, H100) computes the
    equivalent s8 dot_general batched over (prime, n) wrongly at R = 2
    while the CPU is right (PERF.md, Findings).
    """
    return mac_batched(plan, dhat[:, None], ghat[:, None])[:, 0]


def mac_batched(plan: NttPlan, dhat: jnp.ndarray,
                ghat: jnp.ndarray) -> jnp.ndarray:
    """out[p,b,f,j,n] = sum_r dhat[p,b,f,r,n] * ghat[p,b,r,j,n].

    Per-batch GGSW (the vertical-packing case: each byte's selector bit acts
    on its own accumulators, broadcast over the F = LUTs x chunks axis).
    dhat [P, B, F, R, N]; ghat [P, B, R, J, N]; both balanced.

    R = (k+1)*cbs_level and J = k+1 are tiny (5 and 5 at PARAM_OPT), so
    this is an unrolled elementwise limb MAC with N kept minormost.  A
    dot_general batched over (P,B,N) would contract K=R=5, far too small to
    be matrix-unit work, and lets XLA lay the (F, 2J) axes minor, padding
    the vertical-packing intermediates (an earlier layout built a 12 GB
    temporary at 32-block CTR batches this way).
    Limb bounds: |d_limb|, |g_limb| <= 128 -> per-product < 2^14, <= 2*R
    summed terms < 2^17.6 — far inside _combine_limb_dots' 2^20 budget.
    """
    dl, dh = modular.to_balanced_limbs2(dhat)           # [P,B,F,R,N] int8
    gl, gh = modular.to_balanced_limbs2(ghat.astype(I32))   # [P,B,R,J,N]
    r_dim = ghat.shape[-3]
    s_ll = s_mid = s_hh = None
    for r in range(r_dim):
        dlr = dl[..., r, None, :].astype(I32)           # [P,B,F,1,N]
        dhr = dh[..., r, None, :].astype(I32)
        glr = gl[..., r, :, :].astype(I32)[..., None, :, :]  # [P,B,1,J,N]
        ghr = gh[..., r, :, :].astype(I32)[..., None, :, :]
        ll = dlr * glr
        mid = dlr * ghr + dhr * glr
        hh = dhr * ghr
        s_ll = ll if s_ll is None else s_ll + ll
        s_mid = mid if s_mid is None else s_mid + mid
        s_hh = hh if s_hh is None else s_hh + hh
    return _combine_limb_dots(plan, s_ll, s_mid, s_hh)  # [P,B,F,J,N]


def pointwise_mac(plan: NttPlan, dhat: jnp.ndarray,
                  ghat: jnp.ndarray) -> jnp.ndarray:
    """out[k,...,j,n] = sum_r dhat[k,...,r,n] * ghat[k,...,r,j,n]  (mod p_k).

    dhat relaxed-balanced (|.| <= p); ghat balanced (|.| <= p/2): every
    product < 2^30.6 -> reduce, then sum <= R*p/2 < 2^20 -> one final Barrett.
    """
    outs = []
    for k in range(plan.n_primes):
        p = int(plan.p_i32[k]); ip = float(plan.inv_f32[k])
        t = dhat[k][..., :, None, :] * ghat[k][..., :, :, :]
        t = modular.barrett_reduce(t, p, ip)
        s = t.sum(axis=-3, dtype=I32)
        outs.append(modular.barrett_reduce(s, p, ip))
    return jnp.stack(outs)


# ---------------------------------------------------------------------------
# Blind-rotate hot-loop helpers (ops/blind_rotate.py): the step's NTT-domain
# MAC against one BSK row slice, the twiddle rotation, the INTT + CRT.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def rot_table_merged(plan: NttPlan) -> np.ndarray:
    """Prime-merged twiddle table [2N, P*N] int16 (balanced |.| < 2^15.5).

    Row a = the rotation-by-X^a twiddles for ALL primes side by side
    (segment k at lanes k*N..(k+1)*N) — one XLA row-gather per blind-rotate
    step yields the whole merged plane; int16 halves its HBM traffic."""
    t = plan.rot_table                                   # [P, 2N, N] int32
    merged = np.ascontiguousarray(t.transpose(1, 0, 2).reshape(
        t.shape[1], -1))
    assert np.abs(merged).max() < (1 << 15)
    return merged.astype(np.int16)


def mac_rows(plan: NttPlan, dl: jnp.ndarray, dh: jnp.ndarray,
             g_rows: jnp.ndarray, j_out: int) -> jnp.ndarray:
    """NTT-domain external-product MAC against row-major key limbs.

    dl, dh: int8 [P, B, R, N] (dhat limbs); g_rows: int8 [P, R*2J, N]
    (bsk_limbs step slice: row r*2J + j, j < J lo / j >= J hi limb);
    j_out = J = k+1.  Returns balanced int32 [P, B, J, N].

    The contraction over r (R = 15 at PARAM_TPU, 25 at PARAM_OPT) is an
    unrolled elementwise int32 MAC, not a dot_general: XLA:GPU (JAX 0.9.0,
    H100) miscompiles the s8 x s8 -> s32 dot batched over (prime, n) at
    R = 15 — wrong sums, while the CPU is right (PERF.md, Findings) — and
    at so small a contraction the elementwise form is as fast.
    Limb bounds: |d|, |g| <= 128 -> products < 2^14, R <= 25 terms
    < 2^18.7 — inside _combine_limb_dots' 2^20 budget.
    """
    pcount, rr2j, n = g_rows.shape
    g = g_rows.reshape(pcount, rr2j // (2 * j_out), 2 * j_out, n).astype(I32)
    s_lo = s_hi = None
    for r in range(g.shape[1]):
        g_r = g[:, None, r]                             # [P, 1, 2J, N]
        lo = dl[:, :, r, None, :].astype(I32) * g_r     # [P, B, 2J, N]
        hi = dh[:, :, r, None, :].astype(I32) * g_r
        s_lo = lo if s_lo is None else s_lo + lo
        s_hi = hi if s_hi is None else s_hi + hi
    return _combine_limb_dots(plan, s_lo[..., :j_out, :],
                              s_lo[..., j_out:, :] + s_hi[..., :j_out, :],
                              s_hi[..., j_out:, :])


def barrett_rotate_delta(plan: NttPlan, prod: jnp.ndarray, tw: jnp.ndarray,
                         p_c, inv_c) -> jnp.ndarray:
    """(X^a - 1) * prod in the NTT domain: balanced((tw - 1) . prod).

    prod: balanced int32 [P, B, J, N] (|.| <= p/2); tw: balanced twiddle rows
    [P, B, N].  |tw*prod - prod| <= p^2/4 + p/2 < 2^30 -> one Barrett.
    """
    t = tw[:, :, None, :] * prod - prod
    return modular.barrett_reduce(t, p_c, inv_c)


def intt_crt_u64(plan: NttPlan, res: jnp.ndarray,
                 inv_crt_limbs: jnp.ndarray) -> jnp.ndarray:
    """Inverse NTT + explicit-CRT reconstruction -> uint64 [..., N].

    res: balanced int32 [P, ..., N] (|.| <= p/2).  The inverse matrices have
    n^-1 and the CRT premultiplier c_k folded in, so per prime the output is
    z_k = (x * c_k) mod p_k and

        x mod 2^q = sum_k z_k * (M/p_k)  -  round(sum_k z_k/p_k) * M
    with q = plan.q_bits (64 for the torus domain, base^level for the
    mod-switched rotate domain — see ops/blind_rotate.py).
    """
    acc = None
    alpha_fx = None
    for k in range(plan.n_primes):
        p = int(plan.p_i32[k]); ip = float(plan.inv_f32[k])
        z = _apply_limb_matrices(split2(res[k]), inv_crt_limbs, k, p, ip)
        z = modular.barrett_reduce(z, p, ip)
        y = jnp.where(z < 0, z + p, z)                    # canonical [0, p)
        yu = y.astype(jnp.uint64)
        term = yu * jnp.uint64(plan.mk64[k])
        afx = y.astype(jnp.int64) * jnp.int64(plan.fp[k])
        acc = term if acc is None else acc + term
        alpha_fx = afx if alpha_fx is None else alpha_fx + afx
    alpha = (alpha_fx + (1 << (plan.fp_shift - 1))) >> plan.fp_shift
    acc = acc - alpha.astype(jnp.uint64) * jnp.uint64(plan.m64)
    if plan.q_bits < 64:
        acc = acc & jnp.uint64((1 << plan.q_bits) - 1)
    return acc


def u64_to_residues(plan: NttPlan, x: jnp.ndarray) -> jnp.ndarray:
    """u64 values -> balanced residues int32 [P, ...] (device-side).

    Via 8 signed 8-bit limbs dotted with (2^(8i) mod p): |sum| <= 8*128*p/2
    < 2^25 -> one Barrett.
    """
    limbs = []
    carry = jnp.zeros(x.shape, jnp.uint64)
    for i in range(8):
        t = ((x >> jnp.uint64(8 * i)) & jnp.uint64(0xFF)) + carry
        c = (t >= jnp.uint64(128)).astype(jnp.uint64)
        limbs.append((t.astype(jnp.int64) - (c << jnp.uint64(8)).astype(jnp.int64))
                     .astype(I32))
        carry = c
    lim = jnp.stack(limbs, axis=-1)  # int32 [..., 8]
    outs = []
    for k in range(plan.n_primes):
        p = int(plan.p_i32[k]); ip = float(plan.inv_f32[k])
        t = (lim * plan.pow2_8i[k]).sum(axis=-1, dtype=I32)
        outs.append(modular.barrett_reduce(t, p, ip))
    return jnp.stack(outs)
