"""Loader for the native host scalar pipeline (``native/bppp_native.cpp``).

The C++ source is shared with the JAX package and read in place.  It is
compiled with g++ at first use into this package's git-ignored build
directory, keyed by a content hash of the source, so a stale binary is
never picked up after a source change.  The GLV lattice is initialised
from this package's own ``ops.glv`` (``bulletproofspp_tpu.native``
initialises it from ``bulletproofspp_tpu.ops.glv``, which imports JAX).

Without g++ (or when the build fails) every call returns None and the
callers use the pure-Python ``ops.glv``; ``pipeline()`` says which one
runs.  Both give identical MSM results: the C++ split may differ from
the Python one by one lattice step on boundary scalars, but both
decompositions are valid and fit the 33 digit rows (see
``bulletproofspp_tpu/native.py`` for the bound).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .ops import glv

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO, "native", "bppp_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

_lock = threading.Lock()
_state = {"lib": None, "tried": False}


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"bppp_native-{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)  # atomic: concurrent builders race benignly
    return so


def _pack_u64(v: int, limbs: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(8 * limbs, "little"), dtype="<u8").copy()


def _load(so: str):
    lib = ctypes.CDLL(so)
    p64 = ctypes.POINTER(ctypes.c_uint64)
    p32 = ctypes.POINTER(ctypes.c_uint32)
    lib.glv_init.argtypes = [
        ctypes.POINTER(ctypes.c_int64), p64, ctypes.c_int64, p64, ctypes.c_int64, p64,
    ]
    lib.glv_init.restype = None
    lib.glv_recode_batch.argtypes = [p64, ctypes.c_int, p32, p32]
    lib.glv_recode_batch.restype = ctypes.c_int
    lib.recode_signed_one.argtypes = [ctypes.c_int64, p64, p32, p32]
    lib.recode_signed_one.restype = ctypes.c_int

    (a1, b1), (a2, b2) = glv._V1, glv._V2
    det = a1 * b2 - a2 * b1
    if det <= 0:
        raise ValueError("GLV lattice determinant must be positive")
    vecs = [a1, b1, a2, b2]
    signs = np.array([1 if v >= 0 else -1 for v in vecs], dtype=np.int64)
    mags = np.concatenate([_pack_u64(abs(v), 3) for v in vecs])
    g1 = _pack_u64(((abs(b2) << 384) + det // 2) // det, 5)
    g2 = _pack_u64(((abs(b1) << 384) + det // 2) // det, 5)
    lib.glv_init(
        signs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mags.ctypes.data_as(p64),
        1 if b2 >= 0 else -1,
        g1.ctypes.data_as(p64),
        -1 if b1 >= 0 else 1,  # g2 approximates -b1/det
        g2.ctypes.data_as(p64),
    )
    return lib


def get_lib():
    """The initialised ctypes library, or None (use ``ops.glv``)."""
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            so = _build()
            if so is not None:
                _state["lib"] = _load(so)
        return _state["lib"]


def pipeline() -> str:
    """Which scalar pipeline runs: "native" (C++) or "python"."""
    return "native" if get_lib() is not None else "python"


def glv_recode_batch(scalars):
    """list[int] (canonical mod R) -> (absd, sgn) of shape (glv.ROWS, 2n) in the
    engine's interleaved [k1_i, k2_i] lane order."""
    lib = get_lib()
    if lib is None:
        halves = []
        for s in scalars:
            halves.extend(glv.split(s))
        return glv.recode_batch(halves)
    n = len(scalars)
    buf = np.empty((n, 4), dtype="<u8")
    for i, s in enumerate(scalars):
        buf[i] = np.frombuffer(int(s).to_bytes(32, "little"), dtype="<u8")
    absd = np.empty((glv.ROWS, 2 * n), dtype=np.uint32)
    sgn = np.empty((glv.ROWS, 2 * n), dtype=np.uint32)
    rc = lib.glv_recode_batch(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        absd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        sgn.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc != 0:
        raise ValueError("native GLV recode failed: scalar out of range")
    return absd, sgn


def recode_signed(v: int):
    """Signed int (|v| < 2^256) -> (absd, sgn) digit rows, MSB row first."""
    lib = get_lib()
    if lib is None:
        return glv.recode_signed(v)
    absd = np.empty(glv.ROWS, dtype=np.uint32)
    sgn = np.empty(glv.ROWS, dtype=np.uint32)
    rc = lib.recode_signed_one(
        -1 if v < 0 else 1,
        _pack_u64(abs(v), 4).ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        absd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        sgn.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc != 0:
        raise ValueError("scalar too large for digit rows")
    return absd, sgn
