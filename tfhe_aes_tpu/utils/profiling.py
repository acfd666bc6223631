"""Throughput accounting.

The reference's entire telemetry is two wall-clock printlns (main.rs:48-67);
here: the ONE PBS-per-block accounting used by cli.py, bench.py and
chip_smoke.py.  Timings fence with jax.block_until_ready.
"""

from __future__ import annotations


def count_pbs_per_block(params) -> int:
    """PBS-class bootstraps per AES-128 CTR block in this framework.

    The ONE accounting used by cli.py, bench.py and chip_smoke.py.  Each
    circuit-bootstrapped bit costs ``cbs_level`` blind rotates; bit
    extraction costs zero PBS here (1-bit radix blocks degenerate to a
    keyswitch, SURVEY.md 2b):
      encrypt: 10 rounds x 128 bits; add_scalar ripple: 8 + 15 x 9 bits."""
    return (10 * 128 + 8 + 15 * 9) * params.cbs_level


def device_info() -> dict:
    """The device JAX computes on, as every result line names it."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """Each card's name and power limit as nvidia-smi reports them.

    A card set below its maximum power limit runs slower under load, so
    every timing is printed beside this.  Runs nvidia-smi as a child
    process (it never touches JAX); returns 'not available' without one.
    """
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())
