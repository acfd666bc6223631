"""Key-cache roundtrips: v2 (device-layout int8 BSK, zero load-time math)
and the v1 int16-NTT-residue interchange format must load back identically.

The reference never serializes keys (SURVEY.md section 5); this subsystem
exists because production keygen + packing is minutes of work per process.
"""

import numpy as np
import pytest

from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu.client.client import Client
from tfhe_aes_tpu.utils import serialization


@pytest.fixture(scope="module")
def toy_keys():
    client = Client(PARAM_TOY, seed=7)
    return client.sk, client.make_device_keys()


def _assert_same(dk_a, dk_b):
    np.testing.assert_array_equal(np.asarray(dk_a.bsk_limbs),
                                  np.asarray(dk_b.bsk_limbs))
    np.testing.assert_array_equal(np.asarray(dk_a.ksk_limbs),
                                  np.asarray(dk_b.ksk_limbs))
    np.testing.assert_array_equal(np.asarray(dk_a.pfpksk_limbs),
                                  np.asarray(dk_b.pfpksk_limbs))
    assert dk_a.plan.primes == dk_b.plan.primes


@pytest.mark.parametrize("interchange", [False, True],
                         ids=["v2_device_layout", "v1_interchange"])
def test_roundtrip(tmp_path, toy_keys, interchange):
    sk, dkeys = toy_keys
    path = tmp_path / "keys.npz"
    serialization.save_keys(path, sk, dkeys, interchange=interchange)
    sk2, dkeys2 = serialization.load_keys(path)
    np.testing.assert_array_equal(sk.lwe_key, sk2.lwe_key)
    np.testing.assert_array_equal(sk.glwe_key, sk2.glwe_key)
    _assert_same(dkeys, dkeys2)


def test_formats_agree(tmp_path, toy_keys):
    """A v1 file and a v2 file of the same keys load to identical DeviceKeys
    (bsk_residues_to_device is the exact inverse of _bsk_limbs_to_residues)."""
    sk, dkeys = toy_keys
    p1, p2 = tmp_path / "v1.npz", tmp_path / "v2.npz"
    serialization.save_keys(p1, sk, dkeys, interchange=True)
    serialization.save_keys(p2, sk, dkeys, interchange=False)
    _, dk1 = serialization.load_keys(p1)
    _, dk2 = serialization.load_keys(p2)
    _assert_same(dk1, dk2)


def test_slim_device_keys(toy_keys):
    """DeviceKeys carries only what the XLA path reads, and the BSK has one
    row slice per LWE coefficient (no step padding)."""
    import dataclasses
    from tfhe_aes_tpu.ops.keys import DeviceKeys
    sk, dkeys = toy_keys
    p = sk.params
    assert {f.name for f in dataclasses.fields(DeviceKeys)} == {
        "params", "plan", "rplan", "bsk_limbs", "ksk_limbs", "pfpksk_limbs",
        "fwd_limbs", "inv_crt_limbs", "rfwd_limbs", "rinv_crt_limbs",
        "rot_table"}
    kp1 = p.glwe_dimension + 1
    assert np.shape(dkeys.bsk_limbs) == (
        p.lwe_dimension, kp1 * p.pbs_level * 2 * kp1,
        dkeys.rplan.n_primes * p.polynomial_size)


def test_stale_bsk_rows_rejected(tmp_path, toy_keys):
    """A cache whose BSK has another step count (e.g. an older padded
    layout) is refused, not silently run."""
    sk, dkeys = toy_keys
    bsk = np.asarray(dkeys.bsk_limbs)
    padded = np.concatenate([bsk, np.zeros((3,) + bsk.shape[1:], bsk.dtype)])
    path = tmp_path / "stale.npz"
    serialization.save_keys(path, sk, dkeys)
    z = dict(np.load(path))
    z["bsk_limbs"] = padded
    np.savez(path, **z)
    with pytest.raises(ValueError, match="stale key cache"):
        serialization.load_keys(path)

