import os

# Tests run on CPU with a virtual 8-device mesh so sharding/pjit paths are
# exercised without accelerator hardware (standard JAX trick, SURVEY.md
# section 4).  CPU unless JAX_PLATFORMS says otherwise: the tests that need
# the card are marked `gpu` and run as
#   JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
# (README "Quick start"); elsewhere they skip.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
