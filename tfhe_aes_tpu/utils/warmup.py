"""Ahead-of-time compile warm-up: overlap the cold start with key generation.

The reference binary computes immediately (main.rs:48-51) because its hot
loops are precompiled Rust; this framework's equivalents are XLA programs
whose first call compiles them, which takes longer the larger the program
(the CTR step holds 26 WoPBS of 669-step blind rotates).

precompile() compiles those programs from shape-faithful zero key material
(ops.keys.device_keys_shapes) in background threads while real keygen runs:
XLA compilation releases the GIL, so the compiles overlap keygen and each
other on the host CPUs.  The later real calls reuse the executables: every
key leaf is a traced argument (never a baked constant), the NTT plans are
identity-stable across threads (ops.ntt.make_plan locks its cache — a
plan-object race here silently recompiles everything), and with the
persistent compilation cache on (utils/compile_cache) a later process hits
the same entries.

precompile() mirrors exactly the programs bench/cli dispatch:
aes_key_expansion_staged's many-LUT WoPBS, and ctr_keystream's
single-fused-step (<= block_chunk blocks) or ripple + chunked-AES (above).
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp

from ..params import ParamSet

U64 = jnp.uint64


def _materialize(tree):
    """ShapeDtypeStruct leaves -> device zeros (other leaves pass through)."""
    return jax.tree_util.tree_map(
        lambda l: (jnp.zeros(l.shape, l.dtype)
                   if isinstance(l, jax.ShapeDtypeStruct) else l), tree)


def _targets(params: ParamSet, n_blocks: int, block_chunk: int):
    """(name, jitted_fn, arg pytree) for every cold-start program."""
    from ..models import fhe_aes
    from ..ops import keys as keys_mod, wopbs

    p = params
    keys_z = _materialize(keys_mod.device_keys_shapes(p))
    big = p.big_lwe_dimension
    state1 = jnp.zeros((16, 8, big + 1), U64)

    refresh_lut = jnp.asarray(fhe_aes._refresh_sbox_lut(p))
    targets = [("keyexp_wopbs", wopbs.many_wopbs_jit,
                (keys_z, state1, refresh_lut))]

    i_bytes = fhe_aes.counter_bytes(n_blocks)
    lut_lsb, luts_rest = fhe_aes.add_scalar_luts(p, i_bytes)
    lut_lsb, luts_rest = jnp.asarray(lut_lsb), jnp.asarray(luts_rest)
    rks = jnp.zeros((11, 16, 8, big + 1), U64)
    if n_blocks <= block_chunk:
        targets.append(("ctr_step", fhe_aes.ctr_step_jit,
                        (keys_z, rks, state1, lut_lsb, luts_rest)))
    else:
        from ..ops.wopbs import _chunk_size
        bc = _chunk_size(n_blocks, block_chunk)
        stateB = jnp.zeros((n_blocks, 16, 8, big + 1), U64)
        stateC = jnp.zeros((bc, 16, 8, big + 1), U64)
        targets.append(("ripple_add", fhe_aes.add_scalar_device_jit,
                        (keys_z, stateB, lut_lsb, luts_rest)))
        targets.append(("aes_encrypt", fhe_aes.aes_encrypt_jit,
                        (keys_z, rks, stateC)))
    return targets


class Warmup:
    """Compiles running in background threads.

    join() waits for all of them and re-raises the first failure: a program
    that cannot compile from shapes will not compile for the real call
    either, so the run stops here with the compiler's error.  After join(),
    `report` maps each program to its compile seconds and `compiled` to its
    executable (for memory_analysis()).
    """

    def __init__(self, targets, report: dict):
        self.report = report
        self.compiled: dict = {}
        self._errors: list = []
        self._threads = [
            threading.Thread(target=self._compile, args=t, daemon=True)
            for t in targets]
        for t in self._threads:
            t.start()

    def _compile(self, name, fn, args):
        t0 = time.time()
        try:
            self.compiled[name] = fn.lower(*args).compile()
        except Exception as e:      # re-raised in join(), on the caller
            self._errors.append((name, e))
            return
        self.report[name] = round(time.time() - t0, 1)

    def join(self) -> None:
        for t in self._threads:
            t.join()
        if self._errors:
            name, err = self._errors[0]
            raise RuntimeError(f"warm-up compile of {name} failed") from err


def precompile(params: ParamSet, n_blocks: int, *, block_chunk: int = 32,
               report: dict | None = None) -> Warmup:
    """Start compiling the production programs in the background.

    Returns a Warmup to .join() once the (cheap) real-call path is about to
    need the executables.  `report` (optional dict) receives per-program
    compile seconds.  The targets are built SYNCHRONOUSLY: this constructs
    the NTT plans before keygen can race them (see module docstring), and
    stages the zero keys on the device (~0.6 GB at production parameters,
    freed with the Warmup).
    """
    return Warmup(_targets(params, n_blocks, block_chunk),
                  report if report is not None else {})
