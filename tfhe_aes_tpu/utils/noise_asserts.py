"""Runtime noise assertions on REAL ciphertexts — the live sanitizer.

Reference parity: the tfhe-rs `noise-asserts` feature
(/root/reference/Cargo.toml:7) asserts tracked noise <= max_noise_level on
leveled ops INSIDE the real evaluation.  The framework's static audit
(utils/noise.py) proves the schedule obeys the <=5-adds budget on a mock;
this module closes the remaining gap: when
enabled, every WoPBS input/output in the RUNNING pipeline has its phase
error measured against the secret key and checked against the analytic
model's sigma (utils/noise_model.py) — catching schedule bugs the mock
cannot see (a wrong LUT stack or a corrupted ciphertext feeding a hot path
only at production shapes).

Client-side and test-only by construction: measuring phase error requires
the secret key, which never crosses the trust boundary in deployment
(server.py).  Checks ride `jax.debug.callback`, so they fire inside jitted
programs; violations are RECORDED (not raised mid-callback — exceptions
inside XLA host callbacks abort the runtime uncleanly) and surfaced by
`assert_clean()`.

Usage:
    noise_asserts.enable(client.sk)        # BEFORE tracing any program
    ... run circuits ...
    noise_asserts.assert_clean()           # raises on any violation

Messages are single bits at delta 2^63 (client.rs:53-54), so the phase
error of a ciphertext is its signed distance to the nearest multiple of
2^63 — no plaintext needed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import noise_model

U64 = np.uint64


@dataclasses.dataclass
class _State:
    big_key: np.ndarray            # [kN] u64 binary
    budget: noise_model.NoiseBudget
    max_noise_level: int
    tol_sigmas: float
    checks: list
    failures: list


_state: _State | None = None


def enable(sk, *, tol_sigmas: float = 8.0) -> None:
    """Arm the runtime checks.  `sk` is the client's SecretKeys; bounds come
    from the analytic model for sk.params.  tol_sigmas: a measured
    |error| above tol_sigmas * modeled sigma is flagged (8 sigma of a
    correctly-modeled Gaussian fires with p ~ 1e-15 — a flag means the
    schedule, not the luck, is wrong).

    Must run BEFORE the instrumented programs are traced: the hooks are
    trace-time.  Clears jit caches to force retracing.
    """
    global _state
    import jax
    p = sk.params
    _state = _State(
        big_key=np.asarray(sk.big_lwe_key, dtype=U64),
        budget=noise_model.budget(p),
        max_noise_level=p.max_noise_level,
        tol_sigmas=float(tol_sigmas),
        checks=[],
        failures=[],
    )
    jax.clear_caches()


def disable() -> None:
    global _state
    _state = None
    import jax
    jax.clear_caches()


def enabled() -> bool:
    return _state is not None


def checks() -> list:
    return list(_state.checks) if _state else []


def failures() -> list:
    return list(_state.failures) if _state else []


def assert_clean() -> None:
    """Raise if any instrumented point exceeded its noise bound."""
    if _state and _state.failures:
        lines = "\n".join(
            f"  {f['tag']}: max|err| 2^{f['log2_max_err']:.1f} > "
            f"{_state.tol_sigmas:g} * sigma 2^{f['log2_sigma']:.1f} "
            f"(shape {f['shape']})" for f in _state.failures)
        raise AssertionError(f"runtime noise assertions failed:\n{lines}")


def _phase_errors(cts: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Signed distance of each ciphertext's phase to the nearest multiple
    of 2^63 (the two valid bit encodings 0 and 2^63)."""
    cts = np.asarray(cts, dtype=U64)
    ph = cts[..., -1] - np.einsum("...i,i->...", cts[..., :-1], key,
                                  dtype=U64, casting="unsafe").astype(U64)
    half = U64(1) << U64(62)
    e = ((ph + half) & ((U64(1) << U64(63)) - U64(1)))
    return e.astype(np.int64) - np.int64(half)


def _run_check(tag: str, log2_sigma: float, cts: np.ndarray) -> None:
    st = _state
    if st is None:          # disabled between trace and execution
        return
    e = _phase_errors(cts, st.big_key).astype(np.float64)
    max_err = float(np.abs(e).max()) if e.size else 0.0
    rec = {
        "tag": tag,
        "log2_sigma": log2_sigma,
        "log2_max_err": math.log2(max_err) if max_err else float("-inf"),
        "log2_rms": (0.5 * math.log2(float(np.mean(e * e)))
                     if e.size and np.any(e) else float("-inf")),
        "shape": tuple(np.asarray(cts).shape[:-1]),
    }
    st.checks.append(rec)
    if max_err > st.tol_sigmas * 2.0 ** log2_sigma:
        st.failures.append(rec)


def check_big_lwe(tag: str, cts, kind: str):
    """Instrument a batch of big-LWE bit ciphertexts [..., kN+1].

    kind: 'fresh'  — a just-bootstrapped WoPBS output (sigma_wopbs);
          'input'  — a WoPBS input after leveled adds: the <=max_noise_level
                     additions budget (sqrt(level) * sigma_wopbs — the
                     live form of the reference's noise-asserts invariant,
                     README.md:176-180).
    No-op (zero trace cost) unless enable() armed the module.
    """
    if _state is None:
        return cts
    import jax
    b = _state.budget
    if kind == "fresh":
        log2_sigma = b.sigma_wopbs
    elif kind == "input":
        log2_sigma = b.sigma_wopbs + 0.5 * math.log2(_state.max_noise_level)
    else:
        raise ValueError(kind)
    jax.debug.callback(lambda a: _run_check(tag, log2_sigma, a), cts)
    return cts
