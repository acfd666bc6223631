"""The one place that decides where JAX's persistent compilation cache lives.

Every entry point (bench.py, chip_smoke.py, cli.py) calls enable() before
its first compile, so all of them share one cache and a second run of any of
them reuses the programs the first compiled.
"""

from __future__ import annotations

import os
import pathlib

# Inside the checkout (listed in .gitignore): the path is part of the cache
# key, so a fixed location is what lets a later process hit it.
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable() -> pathlib.Path:
    """Turn the persistent compilation cache on and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it on its own and
    nothing is set here; otherwise the cache goes to DEFAULT_DIR.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return pathlib.Path(env)
    import jax
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return DEFAULT_DIR
