"""The XLA blind rotate and vertical packing against the golden model, and
the small pieces of the GPU bring-up: the compile-cache helper, the GPU
check of chip_smoke.py and the CLI's --platform choices.

The blind-rotate cases run chip_smoke's own phase-2 check functions on the
CPU; the `gpu`-marked tests run the same functions on the card.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from tfhe_aes_tpu import cli  # noqa: E402
from tfhe_aes_tpu.client.client import Client  # noqa: E402
from tfhe_aes_tpu.models import luts, tables  # noqa: E402
from tfhe_aes_tpu.ops import wopbs  # noqa: E402
from tfhe_aes_tpu.params import PARAM_TOY, PARAM_TOY_WIDE  # noqa: E402
from tfhe_aes_tpu.utils import compile_cache  # noqa: E402

# PARAM_OPT's decomposition shape (5 levels x 8 bits = 40 digit bits) at
# toy size.
PARAM_TOY_L5 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_L5",
                                   pbs_level=5)
# The production CBS shape: one 15-bit level (PARAM_OPT / PARAM_TPU).
PARAM_TOY_CBS1 = dataclasses.replace(PARAM_TOY, name="PARAM_TOY_CBS1",
                                     cbs_base_log=15, cbs_level=1)


@pytest.mark.parametrize("params,n_batch", [
    (PARAM_TOY, 1), (PARAM_TOY, 3), (PARAM_TOY, 8),
    (PARAM_TOY_L5, 3), (PARAM_TOY_WIDE, 3)],
    ids=["batch1", "batch3", "batch8", "levels5", "wide-digits"])
def test_blind_rotate_decrypts_to_golden(params, n_batch):
    client, rplan, keys, bits, small, test = chip_smoke.rotate_setup(
        params, n_batch)
    acc = chip_smoke.blind_rotate_on(jax.devices("cpu")[0], rplan, params,
                                     keys, small, test)
    assert acc.shape == (n_batch, params.glwe_dimension + 1,
                         params.polynomial_size)
    chip_smoke.check_rotate_decrypts(client, acc, bits)


def test_vertical_packing_cbs_level1_decrypts_to_lut():
    """Single-level 15-bit CBS digits through the XLA vertical packing
    (tree + rotations at N=128) evaluate the S-box."""
    p = PARAM_TOY_CBS1
    client = Client(p, seed=21)
    dkeys = client.make_device_keys()
    sbox = tables.sbox()
    lut = jnp.asarray(luts.lut_polys_from_tables(p, sbox[None], 8))
    vals = (0x00, 0x5A, 0xC3, 0xFF)
    cts = jnp.asarray(np.stack([client.encrypt_byte(b) for b in vals]))
    out = np.asarray(wopbs.many_wopbs(dkeys, cts, lut))
    assert out.shape == (len(vals), 8, p.big_lwe_dimension + 1)
    for i, b in enumerate(vals):
        assert client.decrypt_byte(out[i]) == int(sbox[b])


@pytest.mark.parametrize("env_dir", [True, False], ids=["env-set", "unset"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable() == tmp_path
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = compile_cache.enable()
            assert got == compile_cache.DEFAULT_DIR
            assert jax.config.jax_compilation_cache_dir == str(got)
            root = pathlib.Path(__file__).resolve().parents[1]
            assert got.parent == root
            assert f"{got.name}/" in (root / ".gitignore").read_text()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU.*cpu"):
        chip_smoke.require_gpu()


def test_cli_platform_choices():
    assert cli.PLATFORMS == {"auto": None, "cpu": "cpu", "gpu": "cuda"}
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "tpu", "--params", "toy"])
    assert e.value.code == 2


@pytest.fixture
def gpu():
    """The GPU JAX computes on, or a skip where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is "
                    f"{dev.platform}")
    return dev


@pytest.mark.gpu
@pytest.mark.parametrize("params", [PARAM_TOY, PARAM_TOY_WIDE],
                         ids=["int8-digits", "wide-digits"])
def test_gpu_blind_rotate_matches_cpu(gpu, params):
    chip_smoke.check_blind_rotate(params, 8, [gpu, jax.devices("cpu")[0]])


@pytest.mark.gpu
@pytest.mark.parametrize("r_rows", [15, 25], ids=["PARAM_TPU", "PARAM_OPT"])
def test_gpu_mac_rows_matches_cpu(gpu, r_rows):
    """The blind-rotate MAC at the production row counts, GPU == CPU bit
    for bit (an s8 dot_general formulation of it was wrong on the GPU at
    R = 15)."""
    from tfhe_aes_tpu.ops import keys as keys_mod, ntt
    from tfhe_aes_tpu.params import PARAM_TPU
    rplan = keys_mod.make_rotate_plan(PARAM_TPU)
    rng = np.random.default_rng(3)
    P, B, N = rplan.n_primes, 64, PARAM_TPU.polynomial_size
    args = (rng.integers(-128, 128, (P, B, r_rows, N)).astype(np.int8),
            rng.integers(-128, 128, (P, B, r_rows, N)).astype(np.int8),
            rng.integers(-128, 128, (P, r_rows * 10, N)).astype(np.int8))
    fn = jax.jit(lambda a, b, g: ntt.mac_rows(rplan, a, b, g, 5))
    outs = [np.asarray(fn(*jax.device_put(args, d)))
            for d in (gpu, jax.devices("cpu")[0])]
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.gpu
def test_gpu_main_path(gpu):
    chip_smoke.phase_main("test", params=PARAM_TOY, n_blocks=3)
