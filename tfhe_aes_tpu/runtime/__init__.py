"""Native (C++) host runtime with transparent numpy fallback.

Builds runtime/native.cpp with g++ on first use, as a .so next to the
source whose name carries a hash of the source, the compiler flags and the
machine (ISA and host name).  A binary built on another machine, or from
other sources, therefore never matches and is never loaded: each machine
builds its own.  Every entry point has a numpy fallback so the framework
works without a toolchain.  See native.cpp for what lives here and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).parent
_SRC = _DIR / "native.cpp"
# Portable code for the machine's ISA (no -march=native): the host name in
# the key already confines a binary to the machine that built it; this keeps
# it loadable on any core of that machine.
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None


def _so_path() -> pathlib.Path:
    key = hashlib.sha256(
        _SRC.read_bytes() + repr((_FLAGS, platform.machine(),
                                  platform.node())).encode()).hexdigest()
    return _DIR / f"libtfheaes_native-{key[:16]}.so"


def _build(so: pathlib.Path) -> bool:
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    tmp.replace(so)         # atomic: a concurrent loader never sees half
    return True


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.signed_limbs_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    lib.balanced_residues_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.ntt_rows_mod.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.chacha20_fill_u64.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_uint32]
    _lib = lib
    return _lib


def signed_limbs(v: np.ndarray, n_limbs: int) -> np.ndarray:
    """u64 [...] -> int8 [..., n_limbs] (native; numpy fallback)."""
    lib = get_lib()
    if lib is None:
        from ..utils import torus
        return torus.signed_limbs(v, n_limbs).astype(np.int8)
    v = np.ascontiguousarray(v, dtype=np.uint64)
    out = np.empty(v.shape + (n_limbs,), dtype=np.int8)
    lib.signed_limbs_u64(v.ctypes.data, out.ctypes.data, v.size, n_limbs)
    return out


def balanced_residues(v: np.ndarray, p: int) -> np.ndarray:
    """u64 [...] -> balanced int32 residues mod p (signed representative)."""
    lib = get_lib()
    v = np.ascontiguousarray(v, dtype=np.uint64)
    if lib is None:
        from ..utils import torus
        limbs = torus.signed_limbs(v, 8)
        acc = np.zeros(v.shape, dtype=np.int64)
        for i in range(8):
            acc += limbs[..., i] * pow(2, 8 * i, p)
        r = acc % p
        return np.where(r > p // 2, r - p, r).astype(np.int32)
    out = np.empty(v.shape, dtype=np.int32)
    lib.balanced_residues_u64(v.ctypes.data, out.ctypes.data, v.size, p)
    return out


def ntt_rows_mod(rows: np.ndarray, mat: np.ndarray, p: int) -> np.ndarray:
    """Balanced int32 rows [m, n] x canonical mat [n, n] -> balanced NTT."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    mat_c = np.ascontiguousarray(mat, dtype=np.int32)
    if lib is None:
        from ..utils import crt
        from ..ops import modular
        return modular.host_balanced(
            crt._matmul_mod_f64(rows.astype(np.int64), mat_c.astype(np.int64),
                                p), p).astype(np.int32)
    m, n = rows.shape
    out = np.empty((m, n), dtype=np.int32)
    lib.ntt_rows_mod(rows.ctypes.data, mat_c.ctypes.data, out.ctypes.data,
                     m, n, p)
    return out
