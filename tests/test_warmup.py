"""Cold-start warm-up: shape fidelity and end-to-end precompile.

The warm-up (utils/warmup.py) only works if ops.keys.device_keys_shapes
reports EXACTLY the avals real packed keys have — a silent drift would
recompile every production program after the warm-up already "paid" for
them (a plan-identity race did exactly that once).  These tests pin the
shapes and the plan identity on PARAM_TOY, and that a failed warm-up
compile stops the run.
"""

import dataclasses

import jax
import numpy as np
import pytest

from tfhe_aes_tpu.params import PARAM_TOY
from tfhe_aes_tpu.client import keygen_fast
from tfhe_aes_tpu.ops import keys as keys_mod
from tfhe_aes_tpu.utils import warmup


def test_device_keys_shapes_match_packed_zero_keys():
    zk = keygen_fast.zero_device_keys(PARAM_TOY)
    sh = keys_mod.device_keys_shapes(PARAM_TOY)
    for f in dataclasses.fields(keys_mod.DeviceKeys):
        real, spec = getattr(zk, f.name), getattr(sh, f.name)
        if f.name in ("params", "plan", "rplan"):
            # identity-stable statics: the same OBJECT, or every program
            # the warm-up compiled silently recompiles on the real call
            assert real is spec, f.name
            continue
        assert tuple(np.shape(real)) == tuple(spec.shape), f.name
        assert np.asarray(real).dtype == spec.dtype, f.name


def test_zero_keys_plan_identity_is_thread_race_free():
    # ops.ntt.make_plan must return the SAME object under concurrent first
    # calls (it is an identity-hashed jit static) — regression for the
    # cold-start bug where keygen raced the warm-up thread.
    import threading
    from tfhe_aes_tpu.ops import ntt
    ntt._make_plan.cache_clear()
    out = []
    barrier = threading.Barrier(4)

    def grab():
        barrier.wait()
        out.append(ntt.make_plan(PARAM_TOY.polynomial_size))

    ts = [threading.Thread(target=grab) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert all(o is out[0] for o in out)


def test_failed_warmup_compile_raises_on_join():
    """A program that cannot compile from shapes stops the run at join()
    with the compiler's error, instead of being recorded and ignored."""
    import jax.numpy as jnp
    bad = jax.jit(lambda x: x @ x)              # [2, 3] @ [2, 3]: refused
    w = warmup.Warmup([("bad", bad, (jnp.zeros((2, 3)),))], {})
    with pytest.raises(RuntimeError, match="warm-up compile of bad") as e:
        w.join()
    assert e.value.__cause__ is not None
    assert "bad" not in w.report and "bad" not in w.compiled


@pytest.mark.slow
def test_precompile_end_to_end_toy():
    w = warmup.precompile(PARAM_TOY, 2)
    w.join()
    assert "keyexp_wopbs" in w.report and "ctr_step" in w.report, w.report
    assert set(w.compiled) == set(w.report)
