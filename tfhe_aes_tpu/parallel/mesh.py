"""Device-mesh utilities: sharded FHE-AES CTR over JAX meshes.

Parallelism model (SURVEY.md 2c): the reference's only axis is rayon threads
over CTR blocks (main.rs:55-64).  On a device mesh that becomes:

  * 'dp'  — CTR blocks, pure data parallel (no collectives);
  * 'mp'  — optional second axis over the 16 state bytes: each round's
    WoPBS is byte-independent, and MixColumns' cross-byte sums make XLA
    insert the all-gathers automatically under GSPMD.

Evaluation keys are replicated to every device (read-only, ~1.2 GB at
production parameters) — the all_gather-at-init pattern; no collective rides
the hot loop in the dp-only configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import fhe_aes
from ..ops.keys import DeviceKeys


def make_mesh(n_dp: int | None = None, n_mp: int = 1,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n_dp = n_dp or (len(devices) // n_mp)
    dev = np.asarray(devices[: n_dp * n_mp]).reshape(n_dp, n_mp)
    return Mesh(dev, axis_names=("dp", "mp"))


def shard_keys(mesh: Mesh, keys: DeviceKeys,
               shard_contractions: bool = False) -> DeviceKeys:
    """Stage evaluation keys onto the mesh.

    Default: replicate everything (the all-gather-at-init pattern; no
    collective rides the hot loop).  shard_contractions=True is the
    BASELINE config-#5 layout — sharded LUT evaluation with collective
    reduction: the keyswitch keys' contraction axes are sharded over 'mp'
    (KSK rows [big*ks_level, ...], PFPKSK rows [(big+1)*pfks_level, ...]),
    so GSPMD turns every extract-bits / circuit-bootstrap keyswitch matmul
    into per-device partial sums reduced with an all-reduce over 'mp',
    and per-device key memory drops by the mp factor (~700 MB of the
    ~1.2 GB total at production parameters, SURVEY.md 2b).  The BSK stays
    replicated: every blind-rotate step reads one whole BSK row slice.
    """
    rep = NamedSharding(mesh, P())
    row = NamedSharding(mesh, P("mp"))
    sharded_fields = {"ksk_limbs", "pfpksk_limbs"} if shard_contractions \
        else set()
    updates = {}
    for f in dataclasses.fields(keys):
        if f.metadata.get("static"):
            continue
        a = getattr(keys, f.name)
        updates[f.name] = jax.device_put(
            a, row if f.name in sharded_fields else rep)
    return dataclasses.replace(keys, **updates)


def sharded_ctr_fn(mesh: Mesh, keys: DeviceKeys, n_blocks: int,
                   shard_bytes: bool = False):
    """Build a jitted CTR keystream fn with the batch axis sharded over 'dp'
    (and optionally the byte axis over 'mp').

    Returns fn(keys, round_keys, enc_iv, lut_lsb, luts_rest)
      -> [n_blocks, 16, 8, big+1]
    where `keys` is the DeviceKeys staged by shard_keys (passed here too:
    its shardings become the keys argument's in_shardings) and the LUT
    stacks come from fhe_aes.add_scalar_luts (per-block counter tables,
    sharded along 'dp' with the batch).  The keys are an ARGUMENT, never
    closed over: a closure would bake ~1 GB of key material into the
    program as constants, which XLA then tries to constant-fold.
    """
    byte_spec = "mp" if shard_bytes else None
    state_spec = P("dp", byte_spec)
    rep = NamedSharding(mesh, P())
    dp = NamedSharding(mesh, P("dp"))
    dp1 = NamedSharding(mesh, P(None, "dp"))
    key_shardings = jax.tree_util.tree_map(lambda a: a.sharding, keys)

    def run(keys, round_keys, enc_iv, lut_lsb, luts_rest):
        state = jax.numpy.broadcast_to(enc_iv[None],
                                       (n_blocks,) + enc_iv.shape)
        # The ripple-add stays dp-only: it walks the 16 bytes sequentially
        # (one dynamic-update-slice per step), so 'mp' can't help it — and
        # constraining the byte axis to 'mp' BEFORE the fori_loop made
        # GSPMD miscompile the dynamic-update-slice on the sharded dim
        # (silently wrong keystream; caught by the value-checked dryrun).
        # Bytes shard over 'mp' only for the AES rounds, whose WoPBS
        # batches all 16 bytes at once.
        state = jax.lax.with_sharding_constraint(
            state, NamedSharding(mesh, P("dp")))
        state = fhe_aes.add_scalar_device(keys, state, lut_lsb, luts_rest)
        state = jax.lax.with_sharding_constraint(
            state, NamedSharding(mesh, state_spec))
        return fhe_aes.aes_encrypt(keys, round_keys, state)

    return jax.jit(
        run,
        in_shardings=(key_shardings, rep, rep, dp, dp1),
        out_shardings=NamedSharding(mesh, state_spec),
    )
