#!/usr/bin/env python3
"""Smoke test: the FHE AES-128 CTR path on one NVIDIA GPU, end to end.

    python chip_smoke.py              # one card, the phases below
    python chip_smoke.py --cards 4    # only the 4-card data-parallel path

Phases (each prints its own lines; any failure exits non-zero):

1. device  — JAX's default device must be a GPU; prints its kind, the
   device count, the JAX version and the card's name and power limit.
2. kernels — the XLA blind rotate at production widths, on the GPU and on
   the host CPU in the same process, compared bit for bit (all device
   arithmetic is exact integer math, so the tolerance is 0), at PARAM_TPU
   (12-bit digits, ntt_fwd_wide) and PARAM_OPT (int8 digits,
   ntt_fwd_digits); the sample-extracted result must also decrypt to the
   numpy golden model's expected phase.
3. main    — PARAM_TPU keygen through Client.make_device_keys, then the
   Server facade: key expansion, a 64-block CTR keystream (ripple add at
   the full batch plus chunked AES), decrypted on the client and checked
   bit-exact against plaintext AES, and a homomorphic AES decryption round
   trip.  Timings (block_until_ready), compiled memory and peak device
   memory are printed beside the card name and power limit.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tfhe_aes_tpu.backend import numpy_backend as nb
from tfhe_aes_tpu.client import keygen_fast
from tfhe_aes_tpu.client.client import Client
from tfhe_aes_tpu.models import aes_plain, fhe_aes
from tfhe_aes_tpu.ops import blind_rotate, keys as keys_mod, ntt
from tfhe_aes_tpu.params import PARAM_OPT, PARAM_TPU
from tfhe_aes_tpu.parallel import mesh as mesh_mod
from tfhe_aes_tpu.server import Server
from tfhe_aes_tpu.utils import compile_cache, crt, profiling, torus, warmup

KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
IV = 0x00112233445566778899AABBCCDDEEFF
OUT_LOG = 60          # blind-rotate check: bit b decrypts to b * 2^60
BLOCKS = 64           # main-path CTR batch: ripple add + 2 AES chunks
BLOCKS_PER_CARD = 32  # --cards path
BLOCKS_PER_CHUNK = 32  # fhe_aes.ctr_keystream's block_chunk: one AES round


def require_gpu():
    """JAX's default device, if it is a GPU; otherwise SystemExit naming
    what JAX found instead.  Decided when called, not at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU: JAX's default device is {dev.platform} "
            f"({dev.device_kind}); this check needs an NVIDIA GPU")
    return dev


def phase_device() -> str:
    """Phase 1.  Returns nvidia-smi's '<name>, <power limit>', the label
    printed beside every measurement."""
    jax.config.update("jax_enable_x64", True)
    dev = require_gpu()
    print(f"[device] platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} jax={jax.__version__}")
    card = profiling.card_info()
    print(f"[device] nvidia-smi name, power.limit: {card}")
    print(f"[device] compile cache: {compile_cache.enable()}")
    return card


# -- phase 2: blind rotate, GPU vs CPU vs golden -----------------------------

def rotate_setup(params, n_batch: int, seed: int = 5):
    """A client, its rotate-only device keys, and n_batch real small-LWE
    ciphertexts of random bits, prepared as pbs_boolean prepares them (the
    half-box offset added) — the golden model's boolean-PBS inputs."""

    client = Client(params, seed=seed)
    p = params
    plan = ntt.make_plan(p.polynomial_size, crt.ntt_primes())
    rplan = keys_mod.make_rotate_plan(p)
    bsk = keygen_fast.bsk_gen_fast(client.sk, client.rng, plan)
    keys = dict(bsk_limbs=keygen_fast.stage_bsk(p, client.sk.glwe_key, bsk,
                                                rplan),
                fwd_limbs=rplan.fwd_limbs,
                inv_crt_limbs=rplan.inv_crt_limbs,
                rot_table=ntt.rot_table_merged(rplan))
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_batch).astype(np.uint64)
    small = nb.lwe_encrypt(client.sk.lwe_key, bits << np.uint64(63),
                           p.lwe_noise_std, rng)
    small[..., -1] += np.uint64(1 << 62)
    test = nb.cbs_test_glwe(p, OUT_LOG)
    return client, rplan, keys, bits, small, test


def blind_rotate_on(device, rplan, params, keys, small, test) -> np.ndarray:
    """The jitted XLA blind rotate with every operand on `device`."""
    args = jax.device_put(
        (keys["bsk_limbs"], small, test, keys["fwd_limbs"],
         keys["inv_crt_limbs"], keys["rot_table"]), device)
    fn = jax.jit(blind_rotate.blind_rotate, static_argnums=(0, 1))
    return np.asarray(jax.block_until_ready(fn(rplan, params, *args)))


def check_rotate_decrypts(client, acc: np.ndarray, bits: np.ndarray) -> None:
    """Golden sample extract + decrypt of coefficient 0 must give the
    boolean PBS's expected phase b * 2^60 - 2^59 (nb.pbs_boolean before its
    re-centring add), within 2^54."""
    phase = nb.lwe_phase(client.sk.big_lwe_key, nb.sample_extract(acc, 0))
    want = (bits << np.uint64(OUT_LOG)) - np.uint64(1 << (OUT_LOG - 1))
    if not torus.torus_close(phase, want, 54):
        raise AssertionError(
            f"blind rotate at {client.params.name} does not decrypt to the "
            f"golden phase: bits {bits.tolist()}")


def check_blind_rotate(params, n_batch: int, devices, where: str = "") -> None:
    """Phase-2 check for one parameter set: the blind rotate on each of
    `devices` decrypts right, and all devices agree bit for bit."""
    client, rplan, keys, bits, small, test = rotate_setup(params, n_batch)
    outs = []
    for dev in devices:
        t0 = time.time()
        outs.append(blind_rotate_on(dev, rplan, params, keys, small, test))
        print(f"[kernels] {params.name} blind rotate, batch {n_batch}, on "
              f"{dev.platform}: {time.time() - t0:.2f}s incl. compile "
              f"[{where}]")
        check_rotate_decrypts(client, outs[-1], bits)
    for dev, out in zip(devices[1:], outs[1:]):
        if not np.array_equal(out, outs[0]):
            raise AssertionError(
                f"{params.name} blind rotate: {devices[0].platform} and "
                f"{dev.platform} differ in "
                f"{int(np.sum(out != outs[0]))} words")
    print(f"[kernels] {params.name}: "
          f"{' == '.join(d.platform for d in devices)} bit-exact "
          f"({outs[0].shape}), decrypts to the golden phase")


def time_rotate(params, n_batch: int, where: str, reps: int = 3) -> None:
    """Warm time of the XLA blind rotate at n_batch bits (phase 2 times one
    AES round's batch: BLOCKS_PER_CHUNK x 128 bits) — the baseline a fused
    kernel for this stage has to beat.  Random (not encrypted) inputs: the
    time does not depend on the values."""
    _, rplan, keys, _, _, test = rotate_setup(params, 1)
    rng = np.random.default_rng(0)
    small = rng.integers(0, 1 << 64, (n_batch, params.lwe_dimension + 1),
                         dtype=np.uint64)
    args = jax.device_put((keys["bsk_limbs"], small, test,
                           keys["fwd_limbs"], keys["inv_crt_limbs"],
                           keys["rot_table"]))
    fn = jax.jit(blind_rotate.blind_rotate, static_argnums=(0, 1))
    jax.block_until_ready(fn(rplan, params, *args))
    times = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(fn(rplan, params, *args))
        times.append(time.time() - t0)
    t = min(times)
    print(f"[kernels] {params.name} blind rotate warm, batch {n_batch}: "
          f"{t:.4f}s = {t / params.lwe_dimension * 1e3:.3f} ms/step, "
          f"{n_batch / t:.1f} PBS/s (runs {['%.4f' % x for x in times]}) "
          f"[{where}]")


def phase_kernels(where: str, param_sets=(PARAM_TPU, PARAM_OPT),
                  n_batch: int = 8) -> None:
    """Phase 2: the default device against the host CPU, at both
    production widths."""
    devices = [jax.devices()[0], jax.devices("cpu")[0]]
    for params in param_sets:
        check_blind_rotate(params, n_batch, devices, where)
    time_rotate(param_sets[0], 128 * BLOCKS_PER_CHUNK, where)


# -- phase 3: the main path --------------------------------------------------

def _gib(x) -> str:
    return f"{x / 2**30:.3f} GiB"


def print_memory(name: str, compiled, where: str) -> None:
    m = compiled.memory_analysis()
    print(f"[memory] {name}: "
          f"args {_gib(m.argument_size_in_bytes)}, "
          f"out {_gib(m.output_size_in_bytes)}, "
          f"temp {_gib(m.temp_size_in_bytes)}, "
          f"code {_gib(m.generated_code_size_in_bytes)} [{where}]")


def phase_main(where: str, params=PARAM_TPU, n_blocks: int = BLOCKS,
               seed: int = 0) -> None:
    """Phase 3: keygen, key expansion, CTR, decrypt, all checked."""
    t0 = time.time()
    warm = warmup.precompile(params, n_blocks)   # compiles during keygen
    client = Client(params, seed=seed)
    dkeys = jax.block_until_ready(client.make_device_keys())
    print(f"[main] keygen + upload ({params.name}): {time.time() - t0:.2f}s "
          f"[{where}]")
    warm.join()
    print(f"[main] compile (overlapped with keygen): {warm.report}, joined "
          f"at {time.time() - t0:.2f}s [{where}]")
    for name, compiled in warm.compiled.items():
        print_memory(name, compiled, where)
    del warm

    server = Server(dkeys)
    enc_key = jnp.asarray(client.encrypt_u128(KEY))
    enc_iv = jnp.asarray(client.encrypt_u128(IV))
    for label in ("cold", "warm"):
        t0 = time.time()
        rks = jax.block_until_ready(server.aes_key_expansion(enc_key))
        print(f"[main] key expansion ({label}): {time.time() - t0:.3f}s "
              f"[{where}]")
    want_rks = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(KEY))
    rks_np = np.asarray(rks)
    if [[client.decrypt_byte(rks_np[r, i]) for i in range(16)]
            for r in range(11)] != [list(map(int, r)) for r in want_rks]:
        raise AssertionError("round keys do not decrypt to AES's schedule")
    print("[main] key expansion: 11 round keys decrypt to AES's schedule")

    pbs = n_blocks * profiling.count_pbs_per_block(params)
    times = []
    for i, label in enumerate(("cold", "warm")):
        t0 = time.time()
        ks = jax.block_until_ready(
            server.ctr_keystream(rks, enc_iv, n_blocks, offset=i * n_blocks))
        times.append(time.time() - t0)
        print(f"[main] ctr_keystream {n_blocks} blocks ({label}): "
              f"{times[-1]:.3f}s [{where}]")
    t = times[1]
    print(f"[main] warm CTR: {t:.3f}s per {n_blocks}-block batch, "
          f"{n_blocks / t * 60:.3f} blocks/min, {pbs / t:.1f} PBS/s "
          f"[{where}]")
    offset = n_blocks
    got = client.decrypt_and_verify_ctr(np.asarray(ks), KEY, IV,
                                        offset=offset)
    if got != aes_plain.ctr_keystream(KEY, IV + offset, n_blocks):
        raise AssertionError("CTR keystream differs from plaintext AES")
    print(f"[main] {n_blocks} CTR blocks decrypt bit-exact to plaintext AES "
          f"(first {got[0]:#034x})")

    for label in ("cold", "warm"):
        t0 = time.time()
        back = jax.block_until_ready(server.aes_decrypt(rks, ks[:1]))
        print(f"[main] homomorphic aes_decrypt, 1 block ({label}): "
              f"{time.time() - t0:.3f}s [{where}]")
    if client.decrypt_state_u128(np.asarray(back)[0]) != IV + offset:
        raise AssertionError("homomorphic decryption round trip failed")
    print("[main] homomorphic decrypt round trip: 1 block recovers its "
          "counter")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[main] peak_bytes_in_use: "
          f"{_gib(stats.get('peak_bytes_in_use', 0))} [{where}]")


# -- --cards N: data-parallel CTR over a mesh --------------------------------

def client_round_keys(client, key: int) -> np.ndarray:
    """AES's expanded key, encrypted by the client: [11, 16, 8, big+1]."""
    rks = aes_plain.key_expansion(aes_plain.u128_to_bytes_be(key))
    return np.stack([np.stack([client.encrypt_byte(b) for b in rk])
                     for rk in rks])


def phase_cards(where: str, n_cards: int, params=PARAM_TPU,
                blocks_per_card: int = BLOCKS_PER_CARD,
                seed: int = 0) -> None:
    """parallel/mesh.sharded_ctr_fn on a dp=n_cards mesh, keys replicated,
    blocks_per_card blocks per card, checked bit-exact against one-card
    ctr_keystream runs of the same inputs (card i computes its own blocks
    alone, all cards at once) and against plaintext AES.

    The round keys are encrypted by the client: the homomorphic key
    expansion is phase 3's subject, and this keeps the call to the mesh
    path and what it is compared with."""
    devs = jax.devices()[:n_cards]
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: --cards {n_cards} needs {n_cards} "
                         f"GPUs, JAX sees {len(devs)}")
    n_blocks = n_cards * blocks_per_card
    t0 = time.time()
    client = Client(params, seed=seed)
    dkeys = jax.block_until_ready(client.make_device_keys())
    print(f"[cards] keygen + upload: {time.time() - t0:.2f}s [{where}]")
    rks = client_round_keys(client, KEY)
    enc_iv = client.encrypt_u128(IV)
    lut_lsb, luts_rest = fhe_aes.add_scalar_luts(
        params, fhe_aes.counter_bytes(n_blocks))

    m = mesh_mod.make_mesh(n_dp=n_cards, n_mp=1, devices=devs)
    skeys = mesh_mod.shard_keys(m, dkeys)
    fn = mesh_mod.sharded_ctr_fn(m, skeys, n_blocks)
    sharded_args = (skeys,) + tuple(map(jnp.asarray, (rks, enc_iv, lut_lsb,
                                                      luts_rest)))
    # One-card references: the inputs on card i, as ctr_keystream of card
    # i's blocks dispatches them (ctr_step for <= block_chunk blocks).
    one_card = [jax.device_put((dkeys, rks, enc_iv), d) for d in devs]
    targets = [("sharded", fn, sharded_args)]
    for i, (k, r, v) in enumerate(one_card):
        ll, lr = fhe_aes.add_scalar_luts(params, fhe_aes.counter_bytes(
            blocks_per_card, i * blocks_per_card))
        targets.append((f"card{i}", fhe_aes.ctr_step_jit,
                        (k, r, v, jnp.asarray(ll), jnp.asarray(lr))))
    t0 = time.time()
    warm = warmup.Warmup(targets, {})
    warm.join()
    print(f"[cards] compile (parallel): {warm.report} "
          f"(wall {time.time() - t0:.1f}s) [{where}]")
    print_memory("sharded", warm.compiled["sharded"], where)
    del warm

    pbs = n_blocks * profiling.count_pbs_per_block(params)
    t0 = time.time()
    out = np.asarray(jax.block_until_ready(fn(*sharded_args)))
    t = time.time() - t0
    print(f"[cards] sharded CTR dp={n_cards}, {n_blocks} blocks: {t:.3f}s, "
          f"{n_blocks / t * 60:.3f} blocks/min, {pbs / t:.1f} PBS/s "
          f"[{where}]")

    t0 = time.time()
    refs = [fhe_aes.ctr_keystream(k, r, v, blocks_per_card,
                                  offset=i * blocks_per_card)
            for i, (k, r, v) in enumerate(one_card)]
    ref = np.concatenate([np.asarray(x) for x in jax.block_until_ready(refs)])
    print(f"[cards] {n_cards} one-card ctr_keystream runs of "
          f"{blocks_per_card} blocks, concurrently: {time.time() - t0:.3f}s "
          f"[{where}]")
    if not np.array_equal(out, ref):
        raise AssertionError("sharded keystream differs from the one-card "
                             "runs of the same inputs")
    got = client.decrypt_and_verify_ctr(out, KEY, IV)
    if got != aes_plain.ctr_keystream(KEY, IV, n_blocks):
        raise AssertionError("sharded keystream differs from plaintext AES")
    print(f"[cards] {n_blocks} blocks: sharded == one-card bit-exact, and "
          f"decrypt bit-exact to plaintext AES")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="1 (default): phases 1-3 on one card; N > 1: only "
                         "the N-card data-parallel CTR path and its checks")
    args = ap.parse_args(argv)
    # Phase 2 compares against the host CPU in this process.
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    where = phase_device()
    if args.cards > 1:
        phase_cards(where, args.cards)
    else:
        phase_kernels(where)
        phase_main(where)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
