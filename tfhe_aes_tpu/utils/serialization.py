"""Key serialization / caching.

The reference keeps everything in memory and regenerates keys per run
(SURVEY.md section 5 "Checkpoint / resume: none"); at production parameters
keygen + packing is expensive (~1.2 GB of evaluation keys), so we persist
both secret and packed evaluation keys once per (params, seed) and mmap them
back.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from ..params import (ParamSet, PARAM_OPT, PARAM_TPU, PARAM_TOY,
                      PARAM_TOY_WIDE, PARAM_TOY_N512)
from ..backend.numpy_backend import SecretKeys
from ..ops import ntt
from ..ops.keys import DeviceKeys
from ..utils import crt

_PARAM_SETS = {p.name: p for p in (PARAM_OPT, PARAM_TPU, PARAM_TOY,
                                    PARAM_TOY_WIDE, PARAM_TOY_N512)}


def default_cache_dir() -> pathlib.Path:
    return pathlib.Path(os.environ.get(
        "TFHE_AES_TPU_CACHE", os.path.expanduser("~/.cache/tfhe_aes_tpu")))


# Bump when the packed-key layout changes incompatibly (v5: merged BSK with
# one row slice per LWE coefficient and no step padding,
# ops/keys.bsk_residues_to_device).
KEY_FORMAT = 5


def cache_path(params: ParamSet, seed) -> pathlib.Path:
    """Canonical key-cache location for (params, seed) at KEY_FORMAT."""
    return default_cache_dir() / f"{params.name}_seed{seed}_v{KEY_FORMAT}.npz"


def save_keys(path: pathlib.Path, sk: SecretKeys, dkeys: DeviceKeys, *,
              interchange: bool = False) -> None:
    """Persist secret + packed evaluation keys.

    Default (v2) stores the BSK in the exact device operand layout (int8
    limb rows) so a warm load is mmap + upload with ZERO host math — the
    v1 int16-residue conversion cost ~240 s per process start.
    ``interchange=True`` writes the v1 int16-NTT-residue format instead,
    which is stable across device-layout changes (both load back).
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if interchange:
        bsk_fields = dict(bsk_ntt=_bsk_limbs_to_residues(dkeys))
    else:
        bsk_fields = dict(bsk_limbs=np.asarray(dkeys.bsk_limbs))
    # Atomic write (tmp + rename): callers may save from a background
    # thread (bench overlaps the save with key expansion); an interrupted
    # write must never leave a corrupt cache for the next process.
    tmp = path.parent / (path.name + ".tmp.npz")
    np.savez(
        tmp,
        params_name=np.array(sk.params.name),
        primes=np.array(dkeys.plan.primes, dtype=np.int64),
        rprimes=np.array(dkeys.rplan.primes, dtype=np.int64),
        q_bits=np.array(dkeys.rplan.q_bits, dtype=np.int64),
        lwe_key=sk.lwe_key,
        glwe_key=sk.glwe_key,
        ksk_limbs=np.asarray(dkeys.ksk_limbs),
        pfpksk_limbs=np.asarray(dkeys.pfpksk_limbs),
        **bsk_fields,
    )
    import os
    os.replace(tmp, path)


def _bsk_limbs_to_residues(dkeys: DeviceKeys) -> np.ndarray:
    """Invert keys.bsk_residues_to_device for serialization."""
    merged = np.asarray(dkeys.bsk_limbs)       # [n, R*2(k+1), Pr*N]
    p = dkeys.params
    kp1 = p.glwe_dimension + 1
    n = p.polynomial_size
    pcount = dkeys.rplan.n_primes
    rows = merged.shape[1]
    limbs = (merged.reshape(p.lwe_dimension, rows, pcount, n)
             .transpose(0, 2, 1, 3)            # [n, P, R*2(k+1), N]
             .astype(np.int16))
    limbs = limbs.reshape(p.lwe_dimension, pcount, rows // (2 * kp1),
                          2 * kp1, n)
    return np.ascontiguousarray(
        limbs[..., :kp1, :] + (limbs[..., kp1:, :] << 8))


def load_keys(path: pathlib.Path) -> tuple[SecretKeys, DeviceKeys]:
    z = np.load(path, mmap_mode="r")
    if "rprimes" not in z.files:
        raise ValueError(
            f"stale key cache {path} (pre-rotate-domain format); regenerate")
    params = _PARAM_SETS[str(z["params_name"])]
    sk = SecretKeys(params, np.asarray(z["lwe_key"]),
                    np.asarray(z["glwe_key"]))
    plan = ntt.make_plan(params.polynomial_size,
                         tuple(int(p) for p in z["primes"]))
    rplan = ntt.make_plan(params.polynomial_size,
                          tuple(int(p) for p in z["rprimes"]),
                          q_bits=int(z["q_bits"]))
    if "bsk_limbs" in z.files:                # device layout, zero math
        bsk_limbs = np.asarray(z["bsk_limbs"])
    else:                                     # interchange: int16 residues
        from ..ops.keys import bsk_residues_to_device
        bsk_limbs = bsk_residues_to_device(np.asarray(z["bsk_ntt"]))
    if bsk_limbs.shape[0] != params.lwe_dimension:
        raise ValueError(
            f"stale key cache {path}: BSK has {bsk_limbs.shape[0]} rows, "
            f"{params.name} needs {params.lwe_dimension}; regenerate")
    dkeys = DeviceKeys(
        params=params, plan=plan, rplan=rplan,
        bsk_limbs=bsk_limbs,
        ksk_limbs=np.asarray(z["ksk_limbs"]),
        pfpksk_limbs=np.asarray(z["pfpksk_limbs"]),
        fwd_limbs=plan.fwd_limbs,
        inv_crt_limbs=plan.inv_crt_limbs,
        rfwd_limbs=rplan.fwd_limbs,
        rinv_crt_limbs=rplan.inv_crt_limbs,
        rot_table=ntt.rot_table_merged(rplan),
    )
    return sk, dkeys
