"""The port's hand-written CUDA kernels, their plain versions and launch counts.

Seven kernels carry the prove/verify main path.  Six replace Pallas TPU
kernels of ``bulletproofspp_tpu/ops/pallas_field.py`` (padd, horner,
reduce_block, tail_horner, table_flat, select_reduce); the seventh,
fold, replaces the XLA-only ``fold_mul_kernel`` of
``bulletproofspp_tpu/ops/msm.py``, which as plain PyTorch took most of
the prove time on the card.  Each keeps the contract at the boundary:
(16, N) int64 planes of 16-bit limbs, strict in and out (``ops.limb``);
multiple tables are flat, entry e and limb i of lane j at row 16 e + i
of a (16 E, N) plane.  Sources: ``csrc/kernels.cu`` (entries),
``csrc/curve.cuh`` and ``csrc/field.cuh`` (device functions).

Every wrapper takes the plain version, written below in PyTorch, only for
tensors that lie on the CPU; on a CUDA tensor it launches its kernel or
raises.  It adds one to ``KERNELS[name].launches`` where it launches, and
nowhere else.  The library is built from the sources in the repository
at first use with the nvcc of PyTorch's CUDA home
(``-gencode arch=compute_90a,code=sm_90a``) into the git-ignored
``_build`` directory, keyed by a hash of the sources, and loaded with
ctypes.

What bounds the kernels on the H100 and what their design does about it
is in the header of ``csrc/kernels.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time

import numpy as np
import torch

from . import curve, limb

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("kernels.cu", "curve.cuh", "field.cuh")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@dataclasses.dataclass
class Kernel:
    """One CUDA kernel: its C entry and argument types, the TPU kernel it
    replaces, and the count of launches made through its wrapper."""

    name: str
    entry: str
    argtypes: list
    replaces: str
    launches: int = 0


KERNELS = {
    k.name: k
    for k in (
        Kernel("padd", "bppp_padd", [_P] * 9 + [_I64, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:759"),
        Kernel("horner", "bppp_horner", [_P] * 6 + [_I64, _I64, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:446"),
        Kernel("reduce_block", "bppp_reduce_block", [_P] * 6 + [_I64, _I32, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:490"),
        Kernel("tail_horner", "bppp_tail_horner", [_P] * 6 + [_I64, _I64, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:742"),
        Kernel("table_flat", "bppp_table_flat", [_P] * 6 + [_I64, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:538"),
        Kernel("select_reduce", "bppp_select_reduce", [_P] * 8 + [_I64, _I64, _I64, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:679"),
        Kernel("fold", "bppp_fold", [_P] * 10 + [_I64, _I64, _P],
               "bulletproofspp_tpu/ops/msm.py:247"),
    )
}


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_state: dict = {"lib": None, "build_seconds": None}


def _nvcc() -> str:
    """nvcc under PyTorch's CUDA home (``CUDA_HOME``, else the nvcc on
    ``PATH``, else the toolkit's default location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> str:
    """Compile the kernel library from ``csrc`` (once per source hash);
    returns the path of the shared object."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = os.path.join(BUILD_DIR, f"bppp_kernels-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = so + f".tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, "kernels.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built on first use)."""
    with _lock:
        if _state["lib"] is None:
            t0 = time.perf_counter()
            handle = ctypes.CDLL(build())
            _state["build_seconds"] = time.perf_counter() - t0
            for k in KERNELS.values():
                fn = getattr(handle, k.entry)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
            _state["lib"] = handle
        return _state["lib"]


def build_seconds():
    """Seconds the first ``lib()`` call took (build and load), or None."""
    return _state["build_seconds"]


def _check(*planes):
    dev = planes[0].device
    for t in planes:
        if t.dtype != torch.int64 or t.device != dev or t.shape[0] != limb.NLIMB:
            raise ValueError("kernel inputs must be (16, ...) int64 planes on one device")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs a CUDA tensor, got {dev}")


def _launch(name: str, *args):
    k = KERNELS[name]
    rc = getattr(lib(), k.entry)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    k.launches += 1


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _empty(shape, like):
    return tuple(torch.empty(shape, dtype=torch.int64, device=like.device) for _ in range(3))


# ---------------------------------------------------------------------------
# 1. padd: lane-wise complete addition
# ---------------------------------------------------------------------------


def padd_plain(p, q):
    """Complete addition, strict planes in and out."""
    return curve.tighten3(curve.padd_loose(p, q))


def padd(p, q):
    """P + Q over (16, *batch) strict planes."""
    if p[0].device.type == "cpu":
        return padd_plain(p, q)
    shape = p[0].shape
    flat = [t.reshape(limb.NLIMB, -1).contiguous() for t in (*p, *q)]
    _check(*flat)
    n = flat[0].shape[1]
    out = _empty((limb.NLIMB, n), flat[0])
    _launch("padd", *_ptrs(*flat, *out), n)
    return tuple(t.reshape(shape) for t in out)


# ---------------------------------------------------------------------------
# 2. horner: sum_r 16^(rows-1-r) row_r, MSB row first
# ---------------------------------------------------------------------------


def horner_plain(rx, ry, rz):
    """(16, B, rows) row sums -> (16, B): 4 doublings and 1 addition per row."""
    batch, rows = rx.shape[1], rx.shape[2]
    acc = curve.identity((batch,), rx.device)
    for r in range(rows):
        for _ in range(4):
            acc = curve.pdbl_loose(acc)
        acc = curve.padd_loose(acc, (rx[:, :, r], ry[:, :, r], rz[:, :, r]))
    return curve.tighten3(acc)


def horner(rx, ry, rz):
    if rx.device.type == "cpu":
        return horner_plain(rx, ry, rz)
    rx, ry, rz = (t.contiguous() for t in (rx, ry, rz))
    _check(rx, ry, rz)
    batch, rows = rx.shape[1], rx.shape[2]
    out = _empty((limb.NLIMB, batch), rx)
    _launch("horner", *_ptrs(rx, ry, rz, *out), batch, rows)
    return out


# ---------------------------------------------------------------------------
# 3. reduce_block: narrow (16, W) by factor within blocks of 128 * factor
# ---------------------------------------------------------------------------


def reduce_block_plain(p, factor: int):
    """Halving complete adds inside each block of 128 * factor lanes
    (first half + second half, until 128 lanes remain), as
    ``reduce_block_pallas`` does."""
    w = p[0].shape[1]
    blk = 128 * factor
    p = tuple(t.reshape(limb.NLIMB, w // blk, blk) for t in p)
    width = blk
    while width > 128:
        h = width // 2
        p = curve.padd_loose(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width = h
    return tuple(t.reshape(limb.NLIMB, w // factor) for t in curve.tighten3(p))


def reduce_block(p, factor: int):
    w = p[0].shape[1]
    if factor not in (2, 4, 8) or w % (128 * factor):
        raise ValueError(f"reduce_block: W={w} must be a multiple of 128 * factor, factor in 2/4/8")
    if p[0].device.type == "cpu":
        return reduce_block_plain(p, factor)
    p = tuple(t.contiguous() for t in p)
    _check(*p)
    out = _empty((limb.NLIMB, w // factor), p[0])
    _launch("reduce_block", *_ptrs(*p, *out), w, factor)
    return out


# ---------------------------------------------------------------------------
# 4. tail_horner: per row 128 lanes -> 1, then Horner over the rows
# ---------------------------------------------------------------------------


def tail_horner_plain(p, rows: int):
    """(16, B, rows * 128) -> (16, B).  The 128 lanes of a row halve (t, t
    + 64 first: the order of the Pallas kernel's roll levels), then the
    row sums run through Horner."""
    batch = p[0].shape[1]
    p = tuple(t.reshape(limb.NLIMB, batch, rows, 128) for t in p)
    width = 128
    while width > 1:
        h = width // 2
        p = curve.padd_loose(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width = h
    rx, ry, rz = curve.tighten3(tuple(t[..., 0] for t in p))
    return horner_plain(rx, ry, rz)


def tail_horner(p, rows: int):
    batch, width = p[0].shape[1], p[0].shape[2]
    if width != rows * 128:
        raise ValueError(f"tail_horner: lane width {width} != rows * 128")
    if p[0].device.type == "cpu":
        return tail_horner_plain(p, rows)
    p = tuple(t.contiguous() for t in p)
    _check(*p)
    out = _empty((limb.NLIMB, batch), p[0])
    _launch("tail_horner", *_ptrs(*p, *out), batch, rows)
    return out


# ---------------------------------------------------------------------------
# 5. table_flat: per-lane multiples 0P..8P and the negated Y, flat layout
# ---------------------------------------------------------------------------

TABLE = 9  # entries 0P..8P; the Y table holds 2 * TABLE (then -Y)


def table_flat_plain(p):
    """(16, N) strict lanes -> flat tables tx (144, N), ty2 (288, N), tz
    (144, N): 7 complete additions, then the 9 negated Y."""
    base = p
    entries = [curve.identity(p[0].shape[1:], p[0].device), base]
    acc = base
    for _ in range(TABLE - 2):
        acc = padd_plain(acc, base)
        entries.append(acc)
    ys = [e[1] for e in entries]
    return (torch.cat([e[0] for e in entries]), torch.cat(ys + [limb.neg(y) for y in ys]),
            torch.cat([e[2] for e in entries]))


def table_flat(p):
    if p[0].device.type == "cpu":
        return table_flat_plain(p)
    p = tuple(t.contiguous() for t in p)
    _check(*p)
    n = p[0].shape[1]
    tx, tz = (torch.empty((limb.NLIMB * TABLE, n), dtype=torch.int64, device=p[0].device)
              for _ in range(2))
    ty2 = torch.empty((2 * limb.NLIMB * TABLE, n), dtype=torch.int64, device=p[0].device)
    _launch("table_flat", *_ptrs(*p, tx, ty2, tz), n)
    return tx, ty2, tz


def select_plain(tables, absd, sgn):
    """Flat tables of B * L lanes, digits (B, ROWS, L) -> the selected
    entries (16, B, ROWS, L), by direct indexing."""
    batch, _, L = absd.shape

    def pick(t, idx):
        t = t.view(-1, limb.NLIMB, batch, L).permute(1, 2, 0, 3)  # (16, B, E, L)
        return torch.gather(t, 2, idx.unsqueeze(0).expand(limb.NLIMB, -1, -1, -1))

    tx, ty2, tz = tables
    return pick(tx, absd), pick(ty2, absd + TABLE * sgn), pick(tz, absd)


# ---------------------------------------------------------------------------
# 6. select_reduce: select by digit, then 1024 -> 128 lanes per row
# ---------------------------------------------------------------------------


def select_reduce_plain(tables, absd, sgn):
    """Select each (MSM, row, lane)'s entry, then narrow every row's
    blocks of 1,024 lanes to 128 (reduce_block's halving order).
    Returns (16, B * ROWS * L / 8) row-major partials."""
    sel = select_plain(tables, absd, sgn)
    return reduce_block_plain(tuple(t.reshape(limb.NLIMB, -1) for t in sel), 8)


def select_reduce(tables, absd, sgn):
    batch, rows, L = absd.shape
    if L % 1024:
        raise ValueError(f"select_reduce: lane count {L} must be a multiple of 1024")
    if tables[0].device.type == "cpu":
        return select_reduce_plain(tables, absd, sgn)
    tables = [t.contiguous() for t in tables]
    _check(*(t.view(-1, limb.NLIMB, batch * L)[0] for t in tables))
    absd, sgn = absd.contiguous(), sgn.contiguous()
    if any(d.dtype != torch.int64 or d.device != tables[0].device for d in (absd, sgn)):
        raise ValueError("select_reduce digits must be int64 on the tables' device")
    out = _empty((limb.NLIMB, batch * rows * L // 8), tables[0])
    _launch("select_reduce", *_ptrs(*tables, absd, sgn, *out), batch, rows, L)
    return out


# ---------------------------------------------------------------------------
# 7. fold: per-lane b E + a O with shared digit streams
# ---------------------------------------------------------------------------


def fold_plain(te, to, digits):
    """te, to: the lanes' flat tables (``table_flat``); digits: host (4,
    rows) ints de, se, do, so.  Returns (16, L): per row 4 doublings, + the
    E entry, + the O entry."""
    n = te[0].shape[1]
    acc = curve.identity((n,), te[0].device)

    def entry(t, d, s):
        tx, ty2, tz = (c.view(-1, limb.NLIMB, n) for c in t)
        return tx[d], ty2[d + TABLE * s], tz[d]

    de, se, do, so = ([int(v) for v in row] for row in digits)
    for r in range(len(de)):
        for _ in range(4):
            acc = curve.pdbl_loose(acc)
        acc = curve.padd_loose(acc, entry(te, de[r], se[r]))
        acc = curve.padd_loose(acc, entry(to, do[r], so[r]))
    return curve.tighten3(acc)


def fold(te, to, digits):
    if te[0].device.type == "cpu":
        return fold_plain(te, to, digits)
    tabs = [t.contiguous() for t in (*te, *to)]
    n = tabs[0].shape[1]
    _check(*(t.view(-1, limb.NLIMB, n)[0] for t in tabs))
    digits = np.asarray(digits, np.int64)
    if digits.shape[0] != 4 or digits.min() < 0 or digits[0::2].max() > 8 or digits[1::2].max() > 1:
        raise ValueError("fold digits must be (4, rows): magnitudes 0..8 and signs 0/1")
    rows = digits.shape[1]
    dig = torch.from_numpy(digits).to(tabs[0].device)
    out = _empty((limb.NLIMB, n), tabs[0])
    _launch("fold", *_ptrs(*tabs, dig, *out), n, rows)
    return out
