"""Multi-chip sharding validation on the 8-device virtual CPU mesh."""

import numpy as np
import pytest
import jax

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def test_mesh_construction():
    from tfhe_aes_tpu.parallel import mesh as mesh_mod
    m = mesh_mod.make_mesh(n_dp=4, n_mp=2)
    assert m.devices.shape == (4, 2)
    assert m.axis_names == ("dp", "mp")


@pytest.mark.slow
def test_dryrun_multichip_8():
    """The driver's multi-chip dry run: full CTR step, dp x mp sharding,
    decrypt-verified against the oracle and an unsharded run."""
    import __graft_entry__ as ge
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_dp_only_value_checked():
    """dp-only mesh (the production configuration: pure data parallel over
    CTR blocks, no collectives in the hot loop): sharded keystream must be
    bit-identical to the unsharded run and decrypt to the oracle."""
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from tfhe_aes_tpu.params import ParamSet
    from tfhe_aes_tpu.models import fhe_aes
    from tfhe_aes_tpu.parallel import mesh as mesh_mod

    tiny = ParamSet(
        name="PARAM_DRYRUN", lwe_dimension=8, glwe_dimension=1,
        polynomial_size=64, lwe_noise_std=2.0 ** -30,
        glwe_noise_std=2.0 ** -40, pbs_base_log=8, pbs_level=4,
        ks_base_log=4, ks_level=2, pfks_base_log=12, pfks_level=2,
        cbs_base_log=10, cbs_level=1)
    client, dkeys, rks = ge._setup(tiny)

    KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
    IV = 0xFE  # forces a carry into byte 14 across the batch
    n_blocks = 8
    m = mesh_mod.make_mesh(n_dp=8, n_mp=1)
    sharded_keys = mesh_mod.shard_keys(m, dkeys)
    enc_iv = jnp.asarray(client.encrypt_u128(IV))
    lut_lsb, luts_rest = fhe_aes.add_scalar_luts(
        tiny, fhe_aes.counter_bytes(n_blocks))

    fn = mesh_mod.sharded_ctr_fn(m, sharded_keys, n_blocks)
    out = fn(sharded_keys, jnp.asarray(rks), enc_iv, jnp.asarray(lut_lsb),
             jnp.asarray(luts_rest))
    ref = fhe_aes.ctr_step_jit(dkeys, jnp.asarray(rks), enc_iv,
                               jnp.asarray(lut_lsb), jnp.asarray(luts_rest))
    out_np = np.asarray(jax.device_get(out))
    assert np.array_equal(out_np, np.asarray(jax.device_get(ref)))
    client.decrypt_and_verify_ctr(out_np, KEY, IV)


def test_sharded_key_contractions():
    """BASELINE config #5 layout: KSK/PFPKSK contraction axes sharded over
    'mp' (GSPMD inserts partial-sum all-reduces); results must be
    bit-identical to the replicated-key run."""
    import jax.numpy as jnp
    import __graft_entry__ as ge
    from tfhe_aes_tpu.params import ParamSet
    from tfhe_aes_tpu.models import fhe_aes, luts
    from tfhe_aes_tpu.ops import wopbs
    from tfhe_aes_tpu.parallel import mesh as mesh_mod

    tiny = ParamSet(
        name="PARAM_DRYRUN", lwe_dimension=8, glwe_dimension=1,
        polynomial_size=64, lwe_noise_std=2.0 ** -30,
        glwe_noise_std=2.0 ** -40, pbs_base_log=8, pbs_level=4,
        ks_base_log=4, ks_level=2, pfks_base_log=12, pfks_level=2,
        cbs_base_log=10, cbs_level=1)
    client, dkeys, rks = ge._setup(tiny)
    m = mesh_mod.make_mesh(n_dp=4, n_mp=2)
    skeys = mesh_mod.shard_keys(m, dkeys, shard_contractions=True)
    # Per-device key bytes for the sharded fields must have dropped.
    for name in ("ksk_limbs", "pfpksk_limbs"):
        arr = getattr(skeys, name)
        shard_rows = max(s.data.shape[0] for s in arr.addressable_shards)
        assert shard_rows < arr.shape[0], name

    table = np.arange(256, dtype=np.uint64)[::-1].copy()
    lut = jnp.asarray(luts.lut_polys_from_tables(tiny, table[None], 8))
    state = jnp.asarray(np.stack([client.encrypt_byte(b)
                                  for b in (0x00, 0x5A, 0x99, 0xFF)]))
    ref = np.asarray(wopbs.many_wopbs_jit(dkeys, state, lut))
    got = np.asarray(jax.device_get(wopbs.many_wopbs_jit(skeys, state, lut)))
    assert np.array_equal(ref, got)
    for i, b in enumerate((0x00, 0x5A, 0x99, 0xFF)):
        assert client.decrypt_byte(got[i]) == int(table[b])
