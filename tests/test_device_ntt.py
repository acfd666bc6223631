"""Device NTT kernels vs host golden model (runs on CPU via conftest)."""

import numpy as np
import jax.numpy as jnp

from tfhe_aes_tpu.utils import crt
from tfhe_aes_tpu.ops import ntt, modular
from tfhe_aes_tpu.backend import numpy_backend as nb

RNG = np.random.default_rng(42)


def test_fwd_digits_matches_host():
    n = 512
    plan = ntt.make_plan(n)
    digits = RNG.integers(-128, 128, size=(3, n)).astype(np.int8)
    got = np.asarray(ntt.ntt_fwd_digits(plan, jnp.asarray(digits),
                                        jnp.asarray(plan.fwd_limbs)))
    for k, p in enumerate(plan.primes):
        want = crt.ntt_fwd_host(digits.astype(np.int64), p)
        assert np.array_equal(got[k] % p, want), f"prime {p}"
        assert np.abs(got[k]).max() <= p // 2


def test_fwd_wide_matches_host():
    n = 512
    plan = ntt.make_plan(n)
    vals = RNG.integers(-(1 << 14), 1 << 14, size=(2, n)).astype(np.int32)
    got = np.asarray(ntt.ntt_fwd_wide(plan, jnp.asarray(vals),
                                      jnp.asarray(plan.fwd_limbs)))
    for k, p in enumerate(plan.primes):
        want = crt.ntt_fwd_host(vals.astype(np.int64), p)
        # relaxed balanced: |.| <= p
        assert np.array_equal(got[k] % p, want), f"prime {p}"
        assert np.abs(got[k]).max() <= p


def test_full_polymul_pipeline_u64():
    """digits (int8) x u64 poly, via fwd -> MAC -> INTT+CRT == schoolbook."""
    n = 512
    plan = ntt.make_plan(n)
    digits = RNG.integers(-128, 128, size=(2, 1, n)).astype(np.int8)
    poly = RNG.integers(0, 1 << 64, size=n, dtype=np.uint64)
    want = np.stack([
        nb.negacyclic_mul_u64(digits[b, 0].astype(np.uint64), poly)
        for b in range(2)])[:, None, :]

    dhat = ntt.ntt_fwd_digits(plan, jnp.asarray(digits),
                              jnp.asarray(plan.fwd_limbs))
    ghat_np = np.stack([
        modular.host_balanced(crt.ntt_fwd_host(poly.astype(np.int64) % p, p), p)
        for p in plan.primes]).astype(np.int32)      # [P, N]
    ghat = jnp.asarray(ghat_np)[:, None, None, None, :]  # [P,1,R=1,J=1,N]
    prod = ntt.pointwise_mac(plan, dhat,              # [P,B,R=1,N]
                             jnp.broadcast_to(ghat, (plan.n_primes, 2, 1, 1, n)))
    out = ntt.intt_crt_u64(plan, prod, jnp.asarray(plan.inv_crt_limbs))
    assert np.array_equal(np.asarray(out), want)


def test_u64_to_residues():
    """Residues of a consistent representative: x' == x (mod 2^64), and the
    same signed representative across all primes (what CRT requires)."""
    from tfhe_aes_tpu.utils import torus
    plan = ntt.make_plan(128)
    x = RNG.integers(0, 1 << 64, size=257, dtype=np.uint64)
    got = np.asarray(ntt.u64_to_residues(plan, jnp.asarray(x)))
    limbs = torus.signed_limbs(x, 8)  # signed representative of x mod 2^64
    for k, p in enumerate(plan.primes):
        want = torus.recompose_limbs_mod(limbs, 8, p)
        assert np.array_equal(got[k] % p, want), f"prime {p}"


def test_mac_mxu_matches_golden():
    """The limb MACs (mac_batched, mac_shared, mac_rows) == the elementwise
    golden pointwise_mac."""
    n = 128
    plan = ntt.make_plan(n)
    P = plan.n_primes
    B, F, R, J = 3, 2, 7, 5
    half = np.array(plan.primes, dtype=np.int64) // 2
    dhat = np.stack([RNG.integers(-h, h + 1, size=(B, F, R, n))
                     for h in half]).astype(np.int32)
    ghat = np.stack([RNG.integers(-h, h + 1, size=(B, R, J, n))
                     for h in half]).astype(np.int32)

    got = np.asarray(ntt.mac_batched(plan, jnp.asarray(dhat),
                                     jnp.asarray(ghat)))
    want = np.asarray(ntt.pointwise_mac(
        plan, jnp.asarray(dhat.reshape(P, B, F * R, n).reshape(P, B, F, R, n)),
        jnp.asarray(ghat[:, :, None])))
    for k, p in enumerate(plan.primes):
        assert np.array_equal(got[k] % p, want[k] % p), f"prime {p}"
        assert np.abs(got[k]).max() <= p // 2

    got_s = np.asarray(ntt.mac_shared(plan, jnp.asarray(dhat[:, :, 0]),
                                      jnp.asarray(ghat[:, 0])))
    want_s = np.asarray(ntt.pointwise_mac(
        plan, jnp.asarray(dhat[:, :, 0]), jnp.asarray(ghat[:, None, 0])))
    for k, p in enumerate(plan.primes):
        assert np.array_equal(got_s[k] % p, want_s[k] % p), f"prime {p}"

    # mac_rows: the blind-rotate layout — dhat as two int8 limbs, the key
    # as one [P, R*2J, N] row slice (row r*2J + j: lo limb j < J, hi j >= J)
    from tfhe_aes_tpu.ops import modular
    d0 = dhat[:, :, 0]                                   # [P, B, R, N]
    g0 = ghat[:, 0]                                      # [P, R, J, N]
    dl, dh = modular.to_balanced_limbs2(jnp.asarray(d0))
    gl, gh = modular.to_balanced_limbs2(jnp.asarray(g0))
    g_rows = jnp.concatenate([gl, gh], axis=2).reshape(P, R * 2 * J, n)
    got_r = np.asarray(ntt.mac_rows(plan, dl, dh, g_rows, J))
    for k, p in enumerate(plan.primes):
        assert np.array_equal(got_r[k] % p, want_s[k] % p), f"prime {p}"
        assert np.abs(got_r[k]).max() <= p // 2

