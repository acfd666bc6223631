"""Device-accelerated key generation.

Production keygen is dominated by GLWE mask-times-secret negacyclic products
(~50k polynomial multiplications for BSK + PFPKSK) and by staging the BSK in
the NTT domain.  Both are exactly the workloads the device kernels already
implement, so keygen itself runs on the accelerator: masks are sampled on the
host (numpy CSPRNG), the exact u64 products a_i * S_i run through the RNS-NTT
pipeline in chunks, and noise/messages are added on the host.

Outputs are bit-for-bit the same *distribution* as backend.numpy_backend's
generators (same layouts, same conventions) — validated in tests by phase
roundtrips and by running the full WoPBS pipeline on fast-generated keys.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..params import ParamSet
from ..utils import crt, torus
from ..backend import numpy_backend as nb
from ..ops import keys as keys_mod
from ..ops import ntt

U64 = np.uint64


import functools


@functools.lru_cache(maxsize=None)
def _make_mask_dot(plan: ntt.NttPlan):
    """Returns jitted fn: (a [M, k, N] u64, shat [P,k,1,N]) -> [M, N] u64
    computing sum_i a_i * S_i exactly mod 2^64.

    Cached per plan (plans are identity-stable via make_plan's cache): BSK
    and PFPKSK generation share ONE compiled program instead of compiling
    an identical mask-dot each — rebuilding it per call was ~40% of cold
    keygen (round-5 cold-start study, PERF.md).
    """

    def f(a_u64, shat, fwd_limbs, inv_crt_limbs):
        res = ntt.u64_to_residues(plan, a_u64)          # [P, M, k, N]
        ahat = ntt.ntt_fwd_residues(plan, res, fwd_limbs)
        prod = ntt.mac_shared(plan, ahat, shat)         # [P, M, 1, N]
        return ntt.intt_crt_u64(plan, prod, inv_crt_limbs)[:, 0]

    return jax.jit(f)


def glwe_encrypt_fast(plan: ntt.NttPlan, glwe_key: np.ndarray,
                      msgs: np.ndarray, std: float,
                      rng: np.random.Generator,
                      chunk: int = 4096) -> np.ndarray:
    """Device-accelerated nb.glwe_encrypt: msgs [..., N] -> [..., k+1, N]."""
    k, n = glwe_key.shape
    lead = msgs.shape[:-1]
    m = int(np.prod(lead)) if lead else 1
    msgs2 = msgs.reshape(m, n)
    a = rng.integers(0, 1 << 64, size=(m, k, n), dtype=np.uint64)
    e = torus.sample_gaussian_torus(rng, std, (m, n))

    shat_np = np.stack([
        crt.ntt_fwd_host(glwe_key.astype(np.int64), p)
        for p in plan.primes])                            # [P, k, N] canonical
    from ..ops import modular
    shat_np = np.stack([modular.host_balanced(shat_np[i], p)
                        for i, p in enumerate(plan.primes)]).astype(np.int32)
    shat = jnp.asarray(shat_np)[:, :, None, :]            # [P, k, 1, N]
    fwd = jnp.asarray(plan.fwd_limbs)
    inv_crt = jnp.asarray(plan.inv_crt_limbs)
    dot = _make_mask_dot(plan)

    b = msgs2 + e
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        am = a[lo:hi]
        if hi - lo < chunk and m > chunk:
            # Zero-pad the ragged tail to the full chunk shape: one compiled
            # program for every dispatch (a tail-sized recompile cost ~10 s
            # of cold keygen; the wasted rows are < one chunk of compute).
            am = np.concatenate(
                [am, np.zeros((chunk - (hi - lo),) + am.shape[1:],
                              np.uint64)])
        conv = np.asarray(dot(jnp.asarray(am), shat, fwd, inv_crt))
        b[lo:hi] += conv[:hi - lo]
    out = np.concatenate([a, b[:, None, :]], axis=1)      # [m, k+1, n]
    return out.reshape(lead + (k + 1, n))


def bsk_gen_fast(sk: nb.SecretKeys, rng: np.random.Generator,
                 plan: ntt.NttPlan) -> np.ndarray:
    p = sk.params
    k, n = p.glwe_dimension, p.polynomial_size
    lev = p.pbs_level
    zeros = glwe_encrypt_fast(
        plan, sk.glwe_key,
        np.zeros((p.lwe_dimension, lev, k + 1, n), np.uint64),
        p.glwe_noise_std, rng)
    for l in range(lev):
        g = U64((1 << (64 - p.pbs_base_log * (l + 1))) % (1 << 64))
        for u in range(k + 1):
            zeros[:, l, u, u, 0] += sk.lwe_key * g
    return zeros


def pfpksk_gen_fast(sk: nb.SecretKeys, rng: np.random.Generator,
                    plan: ntt.NttPlan) -> np.ndarray:
    p = sk.params
    k, n = p.glwe_dimension, p.polynomial_size
    big = p.big_lwe_dimension
    bigkey = sk.big_lwe_key
    msgs = np.zeros((k + 1, big + 1, p.pfks_level, n), dtype=np.uint64)
    for u in range(k + 1):
        if u < k:
            sigma = (U64(0) - sk.glwe_key[u])
        else:
            sigma = np.zeros(n, dtype=np.uint64)
            sigma[0] = U64(1)
        for l in range(p.pfks_level):
            g = U64((1 << (64 - p.pfks_base_log * (l + 1))) % (1 << 64))
            msgs[u, :big, l] = (U64(0) - bigkey[:, None]) * sigma[None, :] * g
            msgs[u, big, l] = sigma * g
    return glwe_encrypt_fast(plan, sk.glwe_key, msgs, p.glwe_noise_std, rng)


def make_device_keys_fast(sk: nb.SecretKeys, rng: np.random.Generator,
                          primes=None) -> keys_mod.DeviceKeys:
    """Device-accelerated equivalent of keys.make_device_keys."""
    p = sk.params
    plan = ntt.make_plan(p.polynomial_size, primes or crt.ntt_primes())

    # Eager async uploads: device_put each packed component (~1 GB in all
    # at production parameters) the moment it exists, so the transfers
    # overlap the remaining host keygen work instead of stalling the first
    # real dispatch.
    bsk = bsk_gen_fast(sk, rng, plan)
    ksk = nb.ksk_gen(sk, rng)          # LWE-level: already cheap on host
    ksk_dev = jax.device_put(keys_mod.pack_ksk(p, ksk))
    pfp = pfpksk_gen_fast(sk, rng, plan)
    pfp_dev = jax.device_put(keys_mod.pack_pfpksk(p, pfp))
    return pack_device_keys(p, sk.glwe_key, bsk, ksk, pfp, plan,
                            ksk_packed=ksk_dev, pfp_packed=pfp_dev)


def zero_device_keys(params: ParamSet) -> keys_mod.DeviceKeys:
    """Shape-faithful all-zero evaluation keys.

    For compile warm-up only (bench/cli cold start): every leaf has the
    exact shape/dtype real keys have, so jitting the pipeline on these
    populates the compilation caches for the production programs while
    real keygen still runs.  Decrypting anything evaluated under them is
    meaningless by construction.
    """
    p = params
    k, n = p.glwe_dimension, p.polynomial_size
    plan = ntt.make_plan(p.polynomial_size, crt.ntt_primes())
    bsk = np.zeros((p.lwe_dimension, p.pbs_level, k + 1, k + 1, n), U64)
    ksk = np.zeros((p.big_lwe_dimension, p.ks_level, p.lwe_dimension + 1),
                   U64)
    pfp = np.zeros((k + 1, p.big_lwe_dimension + 1, p.pfks_level, k + 1, n),
                   U64)
    return pack_device_keys(p, np.zeros((k, n), U64), bsk, ksk, pfp, plan)


@functools.lru_cache(maxsize=None)
def _make_stage(rplan: ntt.NttPlan):
    """Jitted BSK NTT-staging program, one compile per rotate plan.

    Cached so warm-up packing (zero_device_keys) and real keygen share the
    compile; rplan is identity-stable via make_rotate_plan's cache."""
    q = rplan.q_bits
    from ..ops import modular
    inv2s = np.stack([modular.host_balanced(
        pow(pow(2, 64 - q, pk), pk - 2, pk), pk)
        for pk in rplan.primes]).astype(np.int32) if q < 64 else None
    p_c = rplan.p_i32.reshape(-1, 1, 1)
    ip_c = rplan.inv_f32.reshape(-1, 1, 1)

    @jax.jit
    def stage(x, rfwd):
        if q < 64:
            x = (x + (jnp.uint64(1) << jnp.uint64(63 - q))) \
                >> jnp.uint64(64 - q)
            x = x << jnp.uint64(64 - q)
        res = ntt.u64_to_residues(rplan, x)             # [P, M, N] balanced
        if q < 64:   # |res * inv2| <= (p/2)^2 < 2^30: one Barrett
            res = modular.barrett_reduce(
                res * jnp.asarray(inv2s).reshape(-1, 1, 1),
                jnp.asarray(p_c), jnp.asarray(ip_c))
        return ntt.ntt_fwd_residues(rplan, res, rfwd).astype(jnp.int16)

    return stage


def stage_bsk(p: ParamSet, glwe_key: np.ndarray, bsk: np.ndarray,
              rplan: ntt.NttPlan):
    """Golden BSK [n, lev, k+1, k+1, N] u64 -> device-resident bsk_limbs.

    NTT staging on device, preserving keys.pack_bsk's layout and values:
    cancel mask rounding errors into the bodies (host, exact f64 convs),
    round to the rotate domain's q' bits, take balanced residues of the
    scaled-back value, unscale by (2^(64-q'))^-1 mod p (== host
    poly_to_ntt_residues_host's shift trick), forward NTT.
    """
    n_lwe, lev, kp1, _, n = bsk.shape
    rows = bsk.transpose(0, 2, 1, 3, 4).reshape(-1, kp1, n)
    rows = keys_mod.cancel_mask_rounding(rows, glwe_key, rplan.q_bits)
    rows = rows.reshape(-1, n)
    rfwd = jnp.asarray(rplan.fwd_limbs)
    stage = _make_stage(rplan)

    outs = []
    chunk = 16384
    nrows = rows.shape[0]
    for lo in range(0, nrows, chunk):
        rm = rows[lo:lo + chunk]
        if rm.shape[0] < chunk and nrows > chunk:
            # pad the ragged tail: one compiled staging program (cold start)
            rm = np.concatenate(
                [rm, np.zeros((chunk - rm.shape[0], rm.shape[1]),
                              rm.dtype)])
        outs.append(np.asarray(stage(jnp.asarray(rm), rfwd)))
    res = np.concatenate(outs, axis=1)[:, :nrows]       # [P, M, N]
    bsk_ntt = np.ascontiguousarray(
        res.reshape(rplan.n_primes, n_lwe, kp1 * lev, kp1, n)
        .transpose(1, 0, 2, 3, 4).astype(np.int16))
    return jax.device_put(keys_mod.bsk_residues_to_device(bsk_ntt))


def pack_device_keys(p: ParamSet, glwe_key: np.ndarray, bsk: np.ndarray,
                     ksk: np.ndarray, pfp: np.ndarray,
                     plan: ntt.NttPlan, *,
                     ksk_packed=None, pfp_packed=None) -> keys_mod.DeviceKeys:
    """Stage host keys into device layouts (shared by real and zero keys).

    ksk_packed/pfp_packed: already-packed (possibly device-resident)
    overrides so callers can start those uploads early (see
    make_device_keys_fast) without packing twice."""
    rplan = keys_mod.make_rotate_plan(p)
    return keys_mod.DeviceKeys(
        params=p, plan=plan, rplan=rplan,
        bsk_limbs=stage_bsk(p, glwe_key, bsk, rplan),
        ksk_limbs=(ksk_packed if ksk_packed is not None
                   else keys_mod.pack_ksk(p, ksk)),
        pfpksk_limbs=(pfp_packed if pfp_packed is not None
                      else keys_mod.pack_pfpksk(p, pfp)),
        fwd_limbs=plan.fwd_limbs,
        inv_crt_limbs=plan.inv_crt_limbs,
        rfwd_limbs=rplan.fwd_limbs,
        rinv_crt_limbs=rplan.inv_crt_limbs,
        rot_table=ntt.rot_table_merged(rplan),
    )
