#!/usr/bin/env python
"""Benchmark: FHE AES-128 CTR throughput on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"params", "blocks", "device", "card"}; progress goes to stderr, each timing
beside the device and card it was taken on.  Baseline: the reference's
published 84 s/block single-core (README.md:184-186) = 0.714 blocks/min.
Metric: CTR keystream blocks/min at production parameters (128-bit
security, p_fail <= 2^-64), bit-exact decryption verified on the client
against the plaintext AES oracle.

Default parameter set: PARAM_TPU — the framework's own production set:
identical security surface to the reference's PARAM_OPT (same dimensions
and noise distributions) with a base-2^12 x 3 BSK decomposition, p_fail
certified analytically (utils/noise_model.py, tests/test_noise_model.py)
and measured (NOISE_REPORT_TPU.md).  `--params prod` benches the
reference-parity PARAM_OPT set.

A measurement needs the GPU: without one the bench exits non-zero, unless
`--platform cpu` asks for a (functional, not comparable) host run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

BASELINE_BLOCKS_PER_MIN = 60.0 / 84.0  # reference: 84 s/block, 1 CPU core


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=64,
                    help="CTR blocks per timed batch; above 32 the ripple "
                         "add runs at the full batch and the AES rounds as "
                         "<=32-block dispatches (fhe_aes.ctr_keystream)")
    ap.add_argument("--params", choices=["prod", "tpu", "toy"],
                    default="tpu",
                    help="prod = reference PARAM_OPT; tpu = PARAM_TPU (same "
                         "security surface, base-2^12 x 3 BSK "
                         "decomposition, certified p_fail <= 2^-64 — "
                         "params.py)")
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                    help="gpu (default) refuses to run without one; cpu "
                         "runs on the host, for checking the bench itself")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--skip-verify", action="store_true")
    ap.add_argument("--decrypt", type=int, default=0, metavar="N",
                    help="also time homomorphic AES decryption of N blocks "
                         "of the produced keystream (reference: ~2x encrypt "
                         "cost, README.md:161-163) and verify the "
                         "round-trip; reported on stderr, the stdout metric "
                         "stays the encrypt headline")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from tfhe_aes_tpu.utils import compile_cache, profiling, serialization
    compile_cache.enable()
    import jax.numpy as jnp

    from tfhe_aes_tpu.params import PARAM_OPT, PARAM_TPU, PARAM_TOY
    from tfhe_aes_tpu.client.client import Client
    from tfhe_aes_tpu.models import fhe_aes

    device = profiling.device_info()
    if device["platform"] != args.platform:
        print(f"bench: needs a {args.platform} device, JAX found "
              f"{device['platform']} ({device['kind']})", file=sys.stderr)
        return 2
    card = profiling.card_info() if device["platform"] == "gpu" else None
    where = f"[{device['kind']} x{device['count']}, card: {card}]"
    params = {"prod": PARAM_OPT, "tpu": PARAM_TPU,
              "toy": PARAM_TOY}[args.params]
    print(f"# device: {where}, params: {params.name}, blocks: {args.blocks}",
          file=sys.stderr)

    # Cold-start overlap: AOT-compile the production programs from shapes
    # alone, in background threads, while keygen runs.
    from tfhe_aes_tpu.utils import warmup
    t0w = time.time()
    warm = warmup.precompile(params, args.blocks)

    cache = serialization.cache_path(params, 0)
    t0 = time.time()
    save_th = None
    if cache.exists():
        sk, dkeys = serialization.load_keys(cache)
        client = Client(params, seed=0)
        client.sk = sk
    else:
        client = Client(params, seed=0)
        dkeys = client.make_device_keys()
        # Save in the background (atomic tmp+rename): the D2H pull for the
        # npz must not sit between keygen and the first real dispatch.
        import threading
        save_th = threading.Thread(
            target=serialization.save_keys,
            args=(cache, client.sk, dkeys), daemon=True)
        save_th.start()
    dkeys = jax.block_until_ready(jax.device_put(dkeys))
    print(f"# keys ready in {time.time()-t0:.1f}s {where}", file=sys.stderr)
    warm.join()
    print(f"# AOT compile warm-up (overlapped with keygen): {warm.report} "
          f"joined at {time.time()-t0w:.1f}s {where}", file=sys.stderr)

    KEY = 0x2B7E151628AED2A6ABF7158809CF4F3C
    IV = 0x00112233445566778899AABBCCDDEEFF
    enc_key = jnp.asarray(client.encrypt_u128(KEY))
    enc_iv = jnp.asarray(client.encrypt_u128(IV))

    # Key expansion runs and is timed EVERY bench run, like the reference
    # (main.rs:48-51): first with its compile, then warm.
    for label in ("incl. compile", "warm"):
        t0 = time.time()
        rks = jax.block_until_ready(
            fhe_aes.aes_key_expansion_staged(dkeys, enc_key))
        print(f"# key expansion ({label}): {time.time()-t0:.2f}s {where}",
              file=sys.stderr)

    B = args.blocks

    # Each timed batch uses a DIFFERENT counter offset, so repeats are
    # distinct keystream work.  Host LUT construction is INSIDE the timed
    # region (a deployment pays it per batch; models/luts.py).
    def run(offset):
        return jax.block_until_ready(
            fhe_aes.ctr_keystream(dkeys, rks, enc_iv, B, offset=offset))

    t0 = time.time()
    out = run(0)  # warmup (includes any compile the warm-up missed)
    print(f"# first batch: {time.time()-t0:.2f}s {where}", file=sys.stderr)

    times = []
    last_offset = 0
    for i in range(args.repeats):
        last_offset = (i + 1) * B
        t0 = time.time()
        out = run(last_offset)
        times.append(time.time() - t0)
        print(f"# repeat {i}: {times[-1]:.3f}s {where}", file=sys.stderr)
    t_batch = min(times)
    blocks_per_min = B / t_batch * 60.0
    pbs_per_block = profiling.count_pbs_per_block(params)
    print(f"# steady-state: {t_batch:.3f}s/batch, "
          f"{B / t_batch * pbs_per_block:.1f} PBS/s {where}", file=sys.stderr)

    if not args.skip_verify:
        t0 = time.time()
        client.decrypt_and_verify_ctr(np.asarray(out), KEY, IV,
                                      offset=last_offset)
        print(f"# verified {B} blocks bit-exact vs plaintext AES on the "
              f"client ({time.time()-t0:.1f}s, outside the metric)",
              file=sys.stderr)

    if args.decrypt:
        # Homomorphic decryption (server.rs:67-105; the reference documents
        # ~2x encrypt cost, README.md:161-163).  Round keys are reused; the
        # round-trip must recover the counter plaintexts.
        nd = min(args.decrypt, B)
        ct = out[:nd]
        for label in ("incl. compile", "warm"):
            t0 = time.time()
            back = jax.block_until_ready(
                fhe_aes.aes_decrypt_jit(dkeys, rks, ct))
            t_dec = time.time() - t0
            print(f"# homomorphic decrypt ({label}): {t_dec:.2f}s for {nd} "
                  f"blocks {where}", file=sys.stderr)
        print(f"# decrypt: {nd / t_dec * 60:.2f} blocks/min (encrypt: "
              f"{blocks_per_min:.2f}) {where}", file=sys.stderr)
        if not args.skip_verify:
            arr = np.asarray(back)
            for i in range(nd):
                got = client.decrypt_state_u128(arr[i])
                if got != (IV + last_offset + i) % (1 << 128):
                    raise SystemExit(f"decrypt round-trip block {i} wrong")
            print(f"# decrypt round-trip verified ({nd} blocks)",
                  file=sys.stderr)

    print(json.dumps({
        "metric": "aes128_ctr_blocks_per_min",
        "value": blocks_per_min,
        "unit": "blocks/min",
        "vs_baseline": blocks_per_min / BASELINE_BLOCKS_PER_MIN,
        "params": params.name,
        "blocks": B,
        "device": device,
        "card": card,
    }))
    sys.stdout.flush()

    if save_th is not None:
        save_th.join()              # finish the atomic key-cache write
    return 0


if __name__ == "__main__":
    sys.exit(main())
