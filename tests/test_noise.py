"""Noise-budget audit wired into CI.

The audit executes the real circuits (utils/noise.py) and asserts the
reference's <=5-leveled-additions invariant (README.md:176-180).  A
deliberately shrunk budget proves the audit can actually fail.
"""

import dataclasses

import pytest

from tfhe_aes_tpu.params import PARAM_OPT, PARAM_TOY
from tfhe_aes_tpu.utils import noise


@pytest.mark.parametrize("params", [PARAM_OPT, PARAM_TOY],
                         ids=lambda p: p.name)
def test_audit_all_within_budget(params):
    out = noise.audit_all(params)
    # The circuit structure pins these exactly: MixColumns depth 4 +
    # AddRoundKey (mix_columns.rs:24-27) and the rescheduled key expansion
    # (n2 = w2 + w1 + w0 + SubWord + RCON) both sit AT the budget.
    assert out["encrypt"]["wopbs_in"] == 5
    assert out["key_expansion"]["wopbs_in"] == 5
    assert out["key_expansion_pk"]["wopbs_in"] == 5
    assert out["ctr_step"]["wopbs_in"] == 5
    assert out["decrypt"]["wopbs_in"] <= 5
    for levels in out.values():
        assert levels["output"] <= params.max_noise_level


def test_audit_catches_violation():
    """With a budget of 4 the real circuits must fail the audit — proving
    the audit derives levels from the circuits rather than from itself."""
    tight = dataclasses.replace(PARAM_OPT, max_noise_level=4)
    with pytest.raises(AssertionError, match="exceeds budget"):
        noise.audit_all(tight)


def test_measured_wopbs_noise_within_budget():
    """Empirical phase-error check: the fresh many-LUT
    WoPBS outputs' measured noise must sit far below the decryption
    threshold with the `max_noise_level` headroom — the runtime complement
    of the static level audit.  (The production-parameter study runs on
    the device: scripts/noise_study.py -> NOISE_REPORT.md.)"""
    import numpy as np
    import jax.numpy as jnp
    from tfhe_aes_tpu.client.client import Client
    from tfhe_aes_tpu.backend import numpy_backend as nb
    from tfhe_aes_tpu.models import luts
    from tfhe_aes_tpu.ops import wopbs

    p = PARAM_TOY
    client = Client(p, seed=21)
    dkeys = client.make_device_keys()
    rng = np.random.default_rng(5)
    U64 = np.uint64

    byts = rng.integers(0, 256, 48).astype(np.int64)
    bits = ((byts[:, None] >> np.arange(8)) & 1).astype(U64)
    cts = nb.lwe_encrypt(client.sk.big_lwe_key, bits << U64(63),
                         p.glwe_noise_std, client.rng)
    ident = jnp.asarray(luts.lut_polys_from_tables(
        p, np.arange(256, dtype=np.uint64)[None], 8))
    out = np.asarray(wopbs.many_wopbs_jit(dkeys, jnp.asarray(cts), ident))
    ph = nb.lwe_phase(client.sk.big_lwe_key, out)        # [B, 8 out bits]
    err = (ph - (bits << U64(63))).astype(np.int64).astype(np.float64)

    sigma = float(np.std(err))
    # Budget: decryption threshold 2^62, p_fail needs >= 9.15 sigma after
    # max_noise_level leveled additions => sigma <= 2^62/(9.15*sqrt(5)).
    budget = 2.0 ** 62 / (9.15 * np.sqrt(p.max_noise_level))
    assert sigma <= budget, (np.log2(sigma), np.log2(budget))
    assert float(np.max(np.abs(err))) < 2.0 ** 62 / 16  # 4-bit hard margin
