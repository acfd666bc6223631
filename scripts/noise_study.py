"""Measured noise study at production parameters.

Measures decrypt-phase error distributions on the device at PARAM_OPT:

  * boolean PBS (blind rotate + sample extract) — batch M bootstraps;
  * full many-LUT WoPBS (KS -> CBS -> vertical packing), identity LUT —
    the primitive whose fresh outputs the AES circuit consumes;
  * the numpy golden model's CLASSIC CMux formulation (mod 2^64, decompose
    the rotated difference, no BSK rounding) as the baseline against which
    the device design's two deltas — twiddle rotation (variance <= 2x) and
    the mod-2^40 rotate domain (BSK-rounding noise) — are quantified
    empirically (ops/blind_rotate.py items 1 and 3).

Budget: the parameter set promises p_fail ~ 6.1e-20 ~ 2^-64 per bootstrap
(reference client.rs:26-30).  For Gaussian phase error that requires
sigma <= 2^62 / 9.15 ~ 2^58.8 at the decryption threshold 2^62; circuit
outputs sit at noise level <= 5 (<=5 summed fresh ciphertexts), so fresh
WoPBS outputs must satisfy sigma_fresh <= 2^58.8 / sqrt(5) ~ 2^57.6.

Writes NOISE_REPORT.md at the repo root and exits nonzero if the measured
sigma exceeds the budget.
"""
from __future__ import annotations

import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

# erfc(y) = 6.1e-20  =>  y ~ 6.47;  |e|/sigma threshold = y*sqrt(2) ~ 9.15
SIGMA_FACTOR = 9.15
THRESHOLD = 2.0 ** 62          # decryption succeeds while |e| < 2^62
MAX_LEVEL = 5                  # <=5 leveled additions between bootstraps


def signed_err(phase_u64: np.ndarray, want_u64: np.ndarray) -> np.ndarray:
    return (phase_u64 - want_u64).astype(np.int64).astype(np.float64)


def main() -> int:
    n_pbs = int(os.environ.get("NOISE_STUDY_PBS", "4096"))
    n_wopbs_bytes = int(os.environ.get("NOISE_STUDY_WOPBS", "512"))
    # Each classic golden bootstrap yields N=512 phase-error samples (every
    # accumulator coefficient), so 8 bootstraps = 4096 samples — and the
    # golden CMux costs ~2 min/bootstrap on this host.
    n_classic = int(os.environ.get("NOISE_STUDY_CLASSIC", "8"))

    from tfhe_aes_tpu.params import PARAM_OPT, PARAM_TPU
    from tfhe_aes_tpu.client.client import Client
    from tfhe_aes_tpu.utils import serialization
    from tfhe_aes_tpu.backend import numpy_backend as nb
    from tfhe_aes_tpu.models import luts
    from tfhe_aes_tpu.ops import cbs, wopbs, lwe as lwe_mod

    tpu_params = "tpu" in sys.argv[1:]
    p = PARAM_TPU if tpu_params else PARAM_OPT
    if tpu_params:
        n_classic = 0          # classic-baseline delta is a PARAM_OPT study
    cache = serialization.cache_path(p, 0)
    sk, dkeys = serialization.load_keys(cache)
    client = Client(p, seed=0)
    client.sk = sk
    dkeys = jax.device_put(dkeys)
    rng = np.random.default_rng(123)
    U64 = np.uint64

    lines = [f"# Measured noise at {p.name} (128-bit, p_fail ~ 2^-64)", "",
             f"Device: {jax.devices()[0]}", "",
             "| stage | samples | sigma (log2) | max err (log2) | "
             "budget sigma (log2) | margin |", "|---|---|---|---|---|---|"]
    budget_fresh = math.log2(THRESHOLD / SIGMA_FACTOR / math.sqrt(MAX_LEVEL))
    ok = True

    # -- boolean PBS (twiddle-rotation kernel), batched ----------------------
    bits = rng.integers(0, 2, n_pbs).astype(U64)
    small = nb.lwe_encrypt(sk.lwe_key, bits << U64(63), p.lwe_noise_std, rng)
    t0 = time.time()
    out = np.asarray(jax.jit(cbs.pbs_boolean, static_argnums=2)(
        dkeys, jnp.asarray(small), 62))
    ph = nb.lwe_phase(sk.big_lwe_key, out)
    err = signed_err(ph, bits << U64(62))
    sig = float(np.std(err))
    mx = float(np.max(np.abs(err)))
    print(f"# PBS x{n_pbs}: {time.time()-t0:.1f}s  sigma=2^{np.log2(sig):.2f}"
          f"  max=2^{np.log2(mx):.2f}", flush=True)
    lines.append(f"| boolean PBS (device, twiddle) | {n_pbs} | "
                 f"{np.log2(sig):.2f} | {np.log2(mx):.2f} | "
                 f"{budget_fresh:.2f} | {budget_fresh - np.log2(sig):.2f} |")
    ok &= np.log2(sig) <= budget_fresh
    pbs_sig = sig

    # -- full WoPBS (identity LUT): the fresh ciphertexts AES consumes -------
    byts = rng.integers(0, 256, n_wopbs_bytes).astype(np.int64)
    bb = ((byts[:, None] >> np.arange(8)) & 1).astype(U64)
    cts = nb.lwe_encrypt(sk.big_lwe_key, bb << U64(63), p.glwe_noise_std,
                         rng)
    ident = jnp.asarray(luts.lut_polys_from_tables(
        p, np.arange(256, dtype=np.uint64)[None], 8))
    t0 = time.time()
    out = np.asarray(wopbs.many_wopbs_jit(dkeys, jnp.asarray(cts), ident))
    ph = nb.lwe_phase(sk.big_lwe_key, out)                  # [B, 8] bits
    err = signed_err(ph, bb << U64(63))
    sig = float(np.std(err))
    mx = float(np.max(np.abs(err)))
    print(f"# WoPBS x{n_wopbs_bytes * 8} bits: {time.time()-t0:.1f}s  "
          f"sigma=2^{np.log2(sig):.2f}  max=2^{np.log2(mx):.2f}", flush=True)
    lines.append(f"| many-LUT WoPBS output (device) | {n_wopbs_bytes * 8} | "
                 f"{np.log2(sig):.2f} | {np.log2(mx):.2f} | "
                 f"{budget_fresh:.2f} | {budget_fresh - np.log2(sig):.2f} |")
    ok &= np.log2(sig) <= budget_fresh
    wopbs_sig = sig

    # -- classic CMux golden model (mod-2^64, no twiddle, no BSK rounding):
    # the baseline the twiddle-rotation + mod-2^40 design is compared to.
    # Every accumulator coefficient is a phase-error sample: the expected
    # accumulator is X^(sum a~_i s_i - b~) * test, computable from sk.
    t0 = time.time()
    if n_classic == 0:
        # PARAM_TPU mode: measured device sigmas only, checked against the
        # analytic model (utils/noise_model) instead of a golden re-baseline.
        from tfhe_aes_tpu.utils import noise_model
        b = noise_model.budget(p)
        lines += [
            "",
            f"Analytic model (utils/noise_model, conservative): "
            f"sigma_pbs 2^{b.sigma_pbs:.2f}, sigma_wopbs(8-step) "
            f"2^{noise_model.budget(p, vp_steps=8).sigma_wopbs:.2f}; "
            f"measured must sit at or below these.",
            "",
            f"Decryption threshold: 2^62; measured fresh-WoPBS margin "
            f"{THRESHOLD / wopbs_sig:.1f} sigma "
            f"({THRESHOLD / wopbs_sig / (SIGMA_FACTOR * math.sqrt(MAX_LEVEL)):.1f}x "
            f"over the level-{MAX_LEVEL} p_fail budget).",
        ]
        ok &= np.log2(pbs_sig) <= b.sigma_pbs
        ok &= np.log2(wopbs_sig) <= noise_model.budget(p, vp_steps=8).sigma_wopbs
        report = "\n".join(lines) + "\n"
        with open(os.path.join(REPO, "NOISE_REPORT_TPU.md"), "w") as f:
            f.write(report)
        print(report)
        print(f"# budget check: {'PASS' if ok else 'FAIL'}", flush=True)
        return 0 if ok else 1
    bits_c = rng.integers(0, 2, n_classic).astype(U64)
    small_c = nb.lwe_encrypt(sk.lwe_key, bits_c << U64(63), p.lwe_noise_std,
                             rng)
    bsk = nb.bsk_gen(sk, np.random.default_rng(0))  # fresh golden BSK
    two_n = 2 * p.polynomial_size
    test = nb.cbs_test_glwe(p, 62)
    errs = []
    for i in range(n_classic):
        ct = small_c[i].copy()
        ct[-1] += U64(1) << U64(62)                 # half-box offset
        acc = nb.blind_rotate(bsk, ct, test, p.pbs_base_log, p.pbs_level)
        ph = nb.glwe_phase(sk.glwe_key, acc)        # [N] u64
        tilde = nb.modswitch(ct, two_n)
        rot = (int((tilde[:-1] * sk.lwe_key.astype(np.int64)).sum())
               - int(tilde[-1])) % two_n
        expected = nb.polynomial_rotate(test[-1], rot)
        errs.append(signed_err(ph, expected))
        print(f"#   classic {i + 1}/{n_classic}: {time.time()-t0:.1f}s",
              flush=True)
    err_c = np.concatenate(errs)
    sig_c = float(np.std(err_c))
    print(f"# classic CMux x{n_classic} ({err_c.size} coeff samples, golden "
          f"CPU): {time.time()-t0:.1f}s  sigma=2^{np.log2(sig_c):.2f}",
          flush=True)
    lines.append(f"| boolean PBS (golden, classic CMux, mod 2^64) | "
                 f"{err_c.size} | {np.log2(sig_c):.2f} | "
                 f"{np.log2(float(np.max(np.abs(err_c)))):.2f} | "
                 f"{budget_fresh:.2f} | — |")

    # Predicted device-PBS sigma from the two design deltas vs the classic
    # golden baseline (ops/blind_rotate.py items 1 and 3):
    #   - twiddle rotation passes BSK noise through (X^a - 1): variance x2;
    #   - mod-2^q' BSK rounding with mask-error cancellation: body-only
    #     uniform +-2^(63-q'), through the same (X^a - 1) conv over n steps.
    r_rows = (p.glwe_dimension + 1) * p.pbs_level
    q_rot = dkeys.rplan.q_bits
    var_round = (2.0 * p.lwe_dimension * p.polynomial_size * r_rows
                 * ((1 << p.pbs_base_log) ** 2 / 12.0)
                 * ((2.0 ** (64 - q_rot)) ** 2 / 12.0))
    pred = math.sqrt(2.0 * sig_c ** 2 + var_round)
    lines += [
        "",
        f"Decryption threshold: 2^62.  A fresh-WoPBS failure needs "
        f"|err| >= {THRESHOLD / wopbs_sig:.1f} sigma of the measured "
        f"distribution (p_fail needs only >= {SIGMA_FACTOR} sigma after "
        f"{MAX_LEVEL} leveled additions) — measured margin "
        f"{THRESHOLD / wopbs_sig / (SIGMA_FACTOR * math.sqrt(MAX_LEVEL)):.1f}x"
        f" over the budget.",
        "",
        f"Device-vs-golden decomposition: the device kernel differs from the "
        f"classic mod-2^64 CMux by (a) the twiddle rotation (BSK-noise "
        f"variance x2, bound documented in ops/blind_rotate.py) and (b) the "
        f"mod-2^{q_rot} rotate domain (BSK rounded to {q_rot} bits at "
        f"staging with mask-error cancellation + one accumulator "
        f"mod-switch).  Predicted device sigma "
        f"sqrt(2*sigma_classic^2 + var_round) = 2^{math.log2(pred):.2f} "
        f"(var_round = 2^{math.log2(var_round):.2f}); measured "
        f"2^{math.log2(pbs_sig):.2f}.  The exact-NTT pipeline has no analog "
        f"of the reference's f64-FFT rounding noise, which the parameter "
        f"optimization already budgets for.",
        "",
        f"Budget model: p_fail 2^-64 needs sigma <= 2^62/9.15 = 2^58.81 at "
        f"decryption; outputs decrypt at noise level <= {MAX_LEVEL} "
        f"(circuit-derived audit, utils/noise.py), so fresh outputs need "
        f"sigma <= 2^{budget_fresh:.2f}.",
    ]
    report = "\n".join(lines) + "\n"
    with open(os.path.join(REPO, "NOISE_REPORT.md"), "w") as f:
        f.write(report)
    print(report)
    print(f"# budget check: {'PASS' if ok else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
