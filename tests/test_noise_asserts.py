"""Runtime noise-assert sanitizer (utils/noise_asserts).

The live complement of the mock-based schedule audit (utils/noise.py):
phase errors of REAL ciphertexts are measured against the secret key at
WoPBS inputs/outputs inside the running (jitted) pipeline and checked
against the analytic model.  Reference parity: tfhe-rs noise-asserts
(/root/reference/Cargo.toml:7).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu.client.client import Client
from tfhe_aes_tpu.models import luts, tables
from tfhe_aes_tpu.ops import wopbs
from tfhe_aes_tpu.utils import noise_asserts

U64 = np.uint64


@pytest.fixture(scope="module")
def ctx():
    client = Client(PARAM_TOY, seed=21)
    dkeys = client.make_device_keys()
    return client, dkeys


@pytest.fixture(autouse=True)
def _disarm():
    yield
    noise_asserts.disable()


def _run_sbox(client, dkeys, byte_cts):
    lut = jnp.asarray(luts.lut_polys_from_tables(
        client.params, tables.sbox()[None], 8))
    out = wopbs.many_wopbs(dkeys, jnp.asarray(byte_cts), lut)
    jax.block_until_ready(out)
    return out


def test_clean_run_passes_and_records(ctx):
    """A healthy pipeline records checkpoints at the WoPBS boundary and
    stays inside the modeled sigma."""
    client, dkeys = ctx
    noise_asserts.enable(client.sk)
    byte_cts = np.stack([client.encrypt_byte(0x3A)])
    _run_sbox(client, dkeys, byte_cts)
    assert len(noise_asserts.checks()) >= 2      # input + output
    tags = {c["tag"] for c in noise_asserts.checks()}
    assert tags == {"wopbs_input", "wopbs_output"}
    noise_asserts.assert_clean()                 # no violations


def test_catches_injected_noise_bug(ctx):
    """A corrupted ciphertext feeding the hot path — the class of schedule
    bug the mock audit cannot see — must be flagged at the WoPBS input."""
    client, dkeys = ctx
    noise_asserts.enable(client.sk)
    byte_cts = np.stack([client.encrypt_byte(0x3A)])
    # Inject: error above the leveled budget (toy bound ~8*sigma ~ 2^58.1)
    # but below the 2^62 decode threshold — the signature of a wrong
    # schedule (too many leveled adds, or a stale/wrong LUT stack).
    byte_cts = byte_cts.copy()
    byte_cts[..., -1] += U64(1) << U64(61)
    _run_sbox(client, dkeys, byte_cts)
    assert any(f["tag"] == "wopbs_input" for f in noise_asserts.failures())
    with pytest.raises(AssertionError, match="wopbs_input"):
        noise_asserts.assert_clean()


def test_disabled_mode_is_inert(ctx):
    """Without enable(), the instrumented code paths add nothing."""
    client, dkeys = ctx
    byte_cts = np.stack([client.encrypt_byte(0x11)])
    _run_sbox(client, dkeys, byte_cts)
    assert noise_asserts.checks() == []
    assert noise_asserts.failures() == []
    noise_asserts.assert_clean()
