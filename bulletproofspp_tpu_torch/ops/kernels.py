"""The port's hand-written CUDA kernels, their plain versions and launch counts.

Twenty-two kernels.  Seven replace Pallas TPU kernels of
``bulletproofspp_tpu/ops/pallas_field.py`` (padd, horner, reduce_block,
tail_horner, table_flat, select_reduce, and select_reduce_fused for MSMs
of 2^21 lanes and more); three replace the Pallas kernels of the JAX
package's measurement tools (sr_variant and grid_copy of
``tools/r5_experiments.py``, chain of ``tools/phase_bench.py``); twelve
replace XLA-only functions: fold (``fold_mul_kernel`` of
``bulletproofspp_tpu/ops/msm.py``, from two table_flat launches' tables;
on no path since fold_many takes the one-prover fold: the route fold_many
is held and timed against), fold_many (basis folding in prove: one
prover's fold and its vmap over the provers of a lockstep batch, from the
bases' points; ``fold_phi`` makes its O basis phi(E) in the launch),
complete_square (the
square completion the JAX package compiles into one program,
``complete_square_kernel`` / ``_csq_with_endo``: phi, that fold and g1 +-
r g0 in one launch) and decompress
(``decompress_kernel`` of ``bulletproofspp_tpu/ops/curve.py``, proof
decoding in verify), which as plain PyTorch dominated the card's time,
and inv and to_affine (``limb.inv`` / ``batch_inv`` and
``curve.to_affine``, the affine conversion of ``fold_bases`` and
``shared_mul``), and the four lane-wise functions of ``csrc/lanes.cu``:
select_small (the table select, which the MSM routes now run inside
reduce_lanes, reduce_block and tail_horner: it stays as their unfused
yardstick), endo (GLV's phi, and the engine's [P, phi(P)] interleave),
pneg (on no path since complete_square makes the square completion's
negation: its unfused yardstick) and normalize3 (canonical planes for one
device-to-host copy; an MSM's result leaves horner or tail_horner
canonical instead, their ``canonical``), and the two device programs the JAX package compiles around
its MSMs and folds: assemble (the oracle step's entry assembly,
``_assemble_many_body`` / ``_assemble_fold`` of
``bulletproofspp_tpu/ops/engine.py``: slices, concatenation, identity
padding, stacking and the [P, phi(P)] interleave in one launch, also
``csrc/lanes.cu``; its segment table by value in the launch) and
reduce_lanes (the table select and lane tree of MSMs under 128 lanes, the
one-hot select and ``_reduce_lanes`` of ``bulletproofspp_tpu/ops/msm.py``,
in ``csrc/kernels.cu``).  Each
keeps the contract at the boundary:
(16, N) int64 planes of 16-bit limbs, strict in and out (``ops.limb``);
multiple tables are flat, entry e and limb i of lane j at row 16 e + i
of a (16 E, N) plane; digits are (B, rows, L) uint8 planes, |d| and the
sign (``_check_digits``; the plain versions widen them for
``torch.gather``).  Sources: one library per entry file of
``SOURCES`` (``csrc/*.cu``), all including ``csrc/curve.cuh`` and
``csrc/field.cuh`` (device functions); ``kernels.cu`` also
``csrc/curve_warp.cuh`` (the cooperative addition and doubling of a warp
or of a group of threads in one), and
``kernels.cu``, ``select_reduce_fused.cu`` and ``tools.cu``
``csrc/select_reduce.cuh`` (the staged row phase select_reduce,
select_reduce_fused and sr_variant share).

Every wrapper takes the plain version, written below in PyTorch, only for
tensors that lie on the CPU; on a CUDA tensor it launches its kernel or
raises.  It adds one to ``KERNELS[name].launches`` (and to the count of
its shape, ``KERNELS[name].shapes``) where it launches, and nowhere
else.  The library is built from the sources in the repository at first
use with the nvcc of PyTorch's CUDA home
(``-gencode arch=compute_90a,code=sm_90a``), one nvcc process per source
file, all started together, into the git-ignored ``_build`` directory,
keyed by a hash of the file and the headers, and loaded with ctypes.

What bounds each kernel on the H100 and what its design does about it
is in the header of its source file.  Four have two designs, picked by
lane count and forced through ``*_design``: select_reduce (staged or the
gather), padd, table_flat and reduce_block (narrow or wide).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from ..core import ec
from . import curve, glv, limb

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
# one library each
SOURCES = ("kernels.cu", "select_reduce_fused.cu", "decompress.cu", "affine.cu", "lanes.cu",
           "tools.cu")
HEADERS = ("curve.cuh", "field.cuh", "curve_warp.cuh", "select_reduce.cuh")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


@dataclasses.dataclass
class Kernel:
    """One CUDA kernel: its source file, C entry and argument types, the
    TPU kernel it replaces, the ``__global__`` functions one launch runs
    (``device_kernels``: each of them once, in order; ``"a|b"`` where the
    launch runs one of a and b), and the count of launches made through
    its wrapper, in all and by shape (``"L=65536"``, ``"B=1 L=4096"``, ...)."""

    name: str
    source: str
    entry: str
    argtypes: list
    replaces: str
    device_kernels: tuple
    launches: int = 0
    shapes: collections.Counter = dataclasses.field(default_factory=collections.Counter)


KERNELS = {
    k.name: k
    for k in (
        Kernel("padd", "kernels.cu", "bppp_padd", [_P] * 9 + [_I64, _I32, _I32, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:759", ("padd_kernel|padd_narrow_kernel",)),
        Kernel("horner", "kernels.cu", "bppp_horner", [_P] * 6 + [_I64, _I64, _I32, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:446", ("horner_warp_kernel",)),
        Kernel("reduce_block", "kernels.cu", "bppp_reduce_block",
               [_P] * 8 + [_I64] * 3 + [_I32, _I32, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:490",
               ("reduce_block_kernel|reduce_block_narrow_kernel",)),
        Kernel("tail_horner", "kernels.cu", "bppp_tail_horner", [_P] * 11 + [_I64, _I64, _I32, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:742",
               ("tail_rows_kernel", "horner_warp_kernel")),
        Kernel("table_flat", "kernels.cu", "bppp_table_flat", [_P] * 6 + [_I64, _I32, _P],
               "bulletproofspp_tpu/ops/pallas_field.py:538",
               ("table_flat_kernel|table_flat_narrow_kernel",)),
        Kernel("select_reduce", "kernels.cu", "bppp_select_reduce",
               [_P] * 8 + [_I64, _I64, _I64, _I32, _P], "bulletproofspp_tpu/ops/pallas_field.py:679",
               ("select_reduce_kernel|select_reduce_rows_kernel",)),
        Kernel("fold", "kernels.cu", "bppp_fold", [_P] * 10 + [_I64, _P],
               "bulletproofspp_tpu/ops/msm.py:247", ("fold_kernel",)),
        Kernel("fold_many", "kernels.cu", "bppp_fold_many",
               [_P] * 10 + [_I64] * 4 + [_I32, _P],
               "bulletproofspp_tpu/ops/msm.py:297", ("fold_many_kernel",)),
        Kernel("complete_square", "kernels.cu", "bppp_complete_square",
               [_P] * 13 + [_I64] * 4 + [_I32, _P],
               "bulletproofspp_tpu/ops/msm.py:283 and :301 (with ops/engine.py:41)",
               ("complete_square_kernel",)),
        Kernel("select_reduce_fused", "select_reduce_fused.cu", "bppp_select_reduce_fused",
               [_P] * 8 + [_I64, _I64, _I64, _P], "bulletproofspp_tpu/ops/pallas_field.py:615",
               ("select_reduce_fused_kernel",)),
        Kernel("decompress", "decompress.cu", "bppp_decompress", [_P] * 4 + [_I64, _P],
               "bulletproofspp_tpu/ops/curve.py:224", ("decompress_kernel",)),
        Kernel("inv", "affine.cu", "bppp_inv", [_P] * 2 + [_I64, _P],
               "bulletproofspp_tpu/ops/limb.py:371/:424", ("inv_kernel",)),
        Kernel("to_affine", "affine.cu", "bppp_to_affine", [_P] * 6 + [_I64, _P],
               "bulletproofspp_tpu/ops/curve.py:156", ("to_affine_kernel",)),
        Kernel("select_small", "lanes.cu", "bppp_select_small", [_P] * 8 + [_I64] * 3 + [_P],
               "bulletproofspp_tpu/ops/msm.py:145", ("select_small_kernel",)),
        Kernel("endo", "lanes.cu", "bppp_endo", [_P] * 6 + [_I64, _I32, _P],
               "bulletproofspp_tpu/ops/curve.py:251 (and ops/engine.py:119)", ("endo_kernel",)),
        Kernel("pneg", "lanes.cu", "bppp_pneg", [_P] * 2 + [_I64, _P],
               "bulletproofspp_tpu/ops/curve.py:87", ("pneg_kernel",)),
        Kernel("normalize3", "lanes.cu", "bppp_normalize3", [_P] * 4 + [_I64, _P],
               "bulletproofspp_tpu/ops/curve.py:124", ("normalize3_kernel",)),
        Kernel("assemble", "lanes.cu", "bppp_assemble",
               [_P, _I64] + [_P] * 3 + [_I64] * 4 + [_I32, _P],
               "bulletproofspp_tpu/ops/engine.py:186 (and :159)", ("assemble_kernel",)),
        Kernel("reduce_lanes", "kernels.cu", "bppp_reduce_lanes",
               [_P] * 8 + [_I64] * 4 + [_I32, _P],
               "bulletproofspp_tpu/ops/msm.py:81 (and the select, :140-156)",
               ("reduce_lanes_kernel",)),
        Kernel("sr_variant", "tools.cu", "bppp_sr_variant", [_P] * 8 + [_I64] * 4 + [_I32, _P],
               "tools/r5_experiments.py:115", ("sr_variant_kernel",)),
        Kernel("grid_copy", "tools.cu", "bppp_grid_copy", [_P] * 2 + [_I64] * 3 + [_P],
               "tools/r5_experiments.py:145", ("grid_copy_kernel",)),
        Kernel("chain", "tools.cu", "bppp_chain", [_I32] + [_P] * 7 + [_I64, _I32, _P, _P],
               "tools/phase_bench.py:43", ("chain_kernel",)),
    )
}


# Kernels no main path launches, each with the route it is the yardstick
# of: the smoke (``chip_smoke.py``) and the tests hold that route against
# it word for word and time them side by side, and require that no main
# path launches it.  Each stays while that check stands.
OFF_PATH = {
    "select_small": "the select in reduce_lanes', reduce_block's and tail_horner's first level",
    "pneg": "complete_square's negation",
    "inv": "to_affine's inverse (limb.inv / limb.batch_inv, which only to_affine calls)",
    "fold": "fold_many at B = 1 and fold_phi (table_flat x 2 + fold, endo + that route)",
}


# the launch counts are bumped by every thread that launches (the lockstep
# prover's threads share one engine), so they change under this lock
_count_lock = threading.Lock()


def reset_counts():
    with _count_lock:
        for k in KERNELS.values():
            k.launches = 0
            k.shapes.clear()


def counts() -> dict:
    with _count_lock:
        return {name: k.launches for name, k in KERNELS.items()}


def shape_counts() -> dict:
    """{kernel: {shape: launches}} since the last ``reset_counts``."""
    with _count_lock:
        return {name: dict(k.shapes) for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_state: dict = {"libs": None, "build_seconds": None}


def _nvcc() -> str:
    """nvcc under PyTorch's CUDA home (``CUDA_HOME``, else the nvcc on
    ``PATH``, else the toolkit's default location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _library_path(source: str) -> str:
    h = hashlib.sha256()
    for name in (source, *HEADERS):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"bppp_{source.split('.')[0]}-{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile each source of ``SOURCES`` that has no library for its hash
    yet, all nvcc processes at once; returns {source: shared object}."""
    sos = {src: _library_path(src) for src in SOURCES}
    todo = [src for src, so in sos.items() if not os.path.exists(so)]
    if not todo:
        return sos
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs, failed = {}, []
    try:
        for src in todo:
            tmp = sos[src] + f".tmp.{os.getpid()}"
            log = tempfile.TemporaryFile("w+")  # a file, not a pipe: no nvcc waits on a full pipe
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs[src] = (tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
        for src, (tmp, log, proc) in procs.items():
            if proc.wait(timeout=900) != 0:
                log.seek(0)
                failed.append(f"{src}: nvcc failed ({proc.returncode}):\n{log.read()}")
            else:
                os.replace(tmp, sos[src])
    finally:
        for _, log, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError("\n".join(failed))
    return sos


def lib() -> dict:
    """The loaded kernel libraries by source (built on first use)."""
    with _lock:
        if _state["libs"] is None:
            t0 = time.perf_counter()
            libs = {src: ctypes.CDLL(so) for src, so in build().items()}
            _state["build_seconds"] = time.perf_counter() - t0
            for k in KERNELS.values():
                fn = getattr(libs[k.source], k.entry)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
            libs["lanes.cu"].bppp_assemble_capacity.argtypes = []
            libs["lanes.cu"].bppp_assemble_capacity.restype = ctypes.c_int64
            _state["libs"] = libs
        return _state["libs"]


def build_seconds():
    """Seconds the first ``lib()`` call took (build and load), or None."""
    return _state["build_seconds"]


def _check(*planes, contiguous: bool = True) -> torch.device:
    """The planes' one CUDA device; raises unless they are (16, ...) int64
    and on it, and, unless ``contiguous`` is False (a kernel that reads
    strided views in place), contiguous."""
    dev = planes[0].device
    for t in planes:
        if t.dtype != torch.int64 or t.device != dev or t.shape[0] != limb.NLIMB:
            raise ValueError("kernel inputs must be (16, ...) int64 planes on one device")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs a CUDA tensor, got {dev}")
    return dev


def _launch(name: str, shape: str, dev: torch.device, *args):
    """Launch under ``dev`` (the tensors' device, from ``_check``) on its
    current stream, whatever the process's current device is."""
    k = KERNELS[name]
    fn = getattr(lib()[k.source], k.entry)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    with _count_lock:
        k.launches += 1
        k.shapes[shape] += 1


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


def _empty(shape, like):
    return tuple(torch.empty(shape, dtype=torch.int64, device=like.device) for _ in range(3))


def _check_tables(name: str, tables, n: int):
    """table_flat's flat tables of n lanes, contiguous, and their CUDA
    device; raises unless they are (144, n), (288, n), (144, n)."""
    tables = [t.contiguous() for t in tables]
    if [t.shape for t in tables] != [(limb.NLIMB * TABLE, n), (2 * limb.NLIMB * TABLE, n),
                                     (limb.NLIMB * TABLE, n)]:
        raise ValueError(f"{name}: tables of {n} lanes must be (144, {n}), (288, {n}), "
                         f"(144, {n})")
    return tables, _check(*(t[:limb.NLIMB] for t in tables))


def _check_digits(name: str, absd, sgn, like):
    """The digit planes, contiguous; raises unless both are uint8 planes of
    one shape on ``like``'s device.  Every kernel reads them as bytes (1/8
    of int64's reads and memory: 138 MB, not 1.1 GB, at 2^21 lanes).  Their
    range is not checked: they come only from the signed recodings
    (``glv.recode_signed``, ``native.recode_signed``: |d| in 0..8, sign 0 or
    1), and a check would read them back to the host, a wait on the card
    every call.  Out of range, a kernel reads outside the tables, where the
    plain versions' ``torch.gather`` raises."""
    absd, sgn = absd.contiguous(), sgn.contiguous()
    if any(d.dtype != torch.uint8 or d.device != like.device or d.shape != absd.shape
           for d in (absd, sgn)):
        raise ValueError(f"{name} digits must be uint8 planes of one shape on the tables' device")
    return absd, sgn


# padd, table_flat and reduce_block have two designs (``csrc/kernels.cu``):
# wide, one thread per (output) lane, and narrow, each addition on a group
# of 8 threads in 2 rounds of 6 field products (``csrc/curve_warp.cuh``).
# Each wrapper takes narrow under a lane count; ``*_design(..., narrow)``
# forces one.


def _design(narrow: bool) -> str:
    """The design's name in the shape counts."""
    return "narrow" if narrow else "wide"


# ---------------------------------------------------------------------------
# 1. padd: lane-wise complete addition
# ---------------------------------------------------------------------------


def padd_plain(p, q):
    """Complete addition, strict planes in and out."""
    return curve.tighten3(curve.padd_loose(p, q))


PADD_THREADS = (128, 256, 512, 1024)

# Lanes a call (the product of the batch shape) from which padd runs its
# wide design.  On the H100 (chip_smoke.py phase 2, both designs in turns
# at PADD_WIDTHS) the narrow design took 0.70-0.78 of the wide one's time
# from 16 to 3,168 lanes (the halving trees and complete_square), 1.00 at
# 8,192, and 1.55-1.72 from 16,384 to 65,536.
PADD_WIDE_LANES = 8192
# the widths both designs are held and timed at: the lane trees' (B x 33 x
# L/2 lanes) and complete_square's, before reduce_lanes and complete_square
# took those additions in, then up to the measurement path's
PADD_WIDTHS = (16, 66, 264, 1056, 3168, 8192, 16384, 32768, 65536)


def padd(p, q, threads: int = 128):
    """P + Q over (16, *batch) strict planes.  On the card the narrow
    design under PADD_WIDE_LANES lanes, the wide one with ``threads`` a
    block (one of ``PADD_THREADS``) from there."""
    return padd_design(p, q, p[0].numel() // limb.NLIMB < PADD_WIDE_LANES, threads)


def padd_design(p, q, narrow: bool, threads: int = 128):
    """``padd`` through one of its two designs: ``narrow``, or the wide one
    with ``threads`` a block (unused by the narrow one).  ``padd`` picks by
    lane count; the smoke picks."""
    if threads not in PADD_THREADS:
        raise ValueError(f"padd: threads must be one of {PADD_THREADS}")
    if p[0].device.type == "cpu":
        return padd_plain(p, q)
    shape = p[0].shape
    flat = [t.reshape(limb.NLIMB, -1).contiguous() for t in (*p, *q)]
    dev = _check(*flat)
    n = flat[0].shape[1]
    out = _empty((limb.NLIMB, n), flat[0])
    _launch("padd", f"L={n} {_design(narrow)}", dev, *_ptrs(*flat, *out), n, threads,
            int(narrow))
    return tuple(t.reshape(shape) for t in out)


# ---------------------------------------------------------------------------
# 2. horner: sum_r 16^(rows-1-r) row_r, MSB row first
# ---------------------------------------------------------------------------


def horner_plain(rx, ry, rz, canonical: bool = False):
    """(16, B, rows) row sums -> (16, B): 4 doublings and 1 addition per row.
    ``canonical``: the stacked (3, 16, B) ``normalize3_plain`` of it."""
    batch, rows = rx.shape[1], rx.shape[2]
    acc = curve.identity((batch,), rx.device)
    for r in range(rows):
        for _ in range(4):
            acc = curve.pdbl_loose(acc)
        acc = curve.padd_loose(acc, (rx[:, :, r], ry[:, :, r], rz[:, :, r]))
    out = curve.tighten3(acc)
    return normalize3_plain(*out) if canonical else out


def _horner_out(batch: int, canonical: bool, like):
    """The result of an MSM's last launch: three (16, B) planes, or with
    ``canonical`` one stacked (3, 16, B) tensor (its three planes, and it)."""
    if not canonical:
        out = _empty((limb.NLIMB, batch), like)
        return out, out
    out = torch.empty((3, limb.NLIMB, batch), dtype=torch.int64, device=like.device)
    return tuple(out), out


def horner(rx, ry, rz, canonical: bool = False):
    """``horner_plain`` on the card in one launch (one warp an MSM).  With
    ``canonical`` the last warp stores ``fe_canon`` of X, Y and Z into one
    stacked (3, 16, B) tensor: ``normalize3`` of the result, word for word,
    without its launch."""
    if rx.device.type == "cpu":
        return horner_plain(rx, ry, rz, canonical)
    rx, ry, rz = (t.contiguous() for t in (rx, ry, rz))
    dev = _check(rx, ry, rz)
    batch, rows = rx.shape[1], rx.shape[2]
    planes, out = _horner_out(batch, canonical, rx)
    _launch("horner", f"K={batch}" + (" canonical" if canonical else ""), dev,
            *_ptrs(rx, ry, rz, *planes), batch, rows, int(canonical))
    return out


# ---------------------------------------------------------------------------
# 3. reduce_block: narrow (16, W) by factor within blocks of 128 * factor
# ---------------------------------------------------------------------------


def _selected(tables, absd, sgn):
    """The points the (B, rows, L) digits select, as (16, B rows L) planes."""
    return tuple(t.reshape(limb.NLIMB, -1) for t in select_plain(tables, absd, sgn))


def reduce_block_plain(p, factor: int, absd=None, sgn=None):
    """Halving complete adds inside each block of 128 * factor lanes
    (first half + second half, until 128 lanes remain), as
    ``reduce_block_pallas`` does.  With digits, over the points they select
    from the flat tables ``p`` (``select_plain``, flattened)."""
    if absd is not None:
        p = _selected(p, absd, sgn)
    w = p[0].shape[1]
    blk = 128 * factor
    p = tuple(t.reshape(limb.NLIMB, w // blk, blk) for t in p)
    width = blk
    while width > 128:
        h = width // 2
        p = curve.padd_loose(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width = h
    return tuple(t.reshape(limb.NLIMB, w // factor) for t in curve.tighten3(p))


# Output lanes a call (W / factor) from which reduce_block runs its wide
# design (one thread per output lane); under it the narrow one runs the
# halving tree by levels, each addition on a group of 8 threads.  On the
# H100 (chip_smoke.py phase 2, both designs in turns at
# REDUCE_BLOCK_WIDTHS) the narrow design took 0.75 (f = 2), 0.68 (f = 4)
# and 0.81 (f = 8) of the wide one's time at 4,224 output lanes; 0.99 (f =
# 2) and 1.22 (f = 4) at 8,448; 1.41-2.89 from 16,896, where the wide
# design's one thread a lane keeps the SMs busy.
REDUCE_BLOCK_WIDE_LANES = 8448
# the (W, factor) pairs both designs are held and timed at: the main
# paths' launches (cli test's MSMs of 256 to 4,096 lanes, one to 130 at a
# time; the bench's, the batch's and the 2^21-lane MSM's)
REDUCE_BLOCK_WIDTHS = ((8448, 2), (16896, 2), (16896, 4), (33792, 2), (33792, 4), (33792, 8),
                       (42240, 2), (135168, 8), (270336, 8), (557568, 2), (1081344, 8),
                       (1655808, 4), (2196480, 4), (8650752, 8))


def reduce_block(p, factor: int, absd=None, sgn=None):
    """``reduce_block_plain`` on the card: the narrow design under
    REDUCE_BLOCK_WIDE_LANES output lanes, the wide one from there.  With
    (B, rows, L) uint8 digits ``absd`` and ``sgn``, ``p`` is table_flat's
    flat tables of B L lanes and the W = B rows L input lanes are the
    points the digits select: the first level gathers them by digit
    (msm's route from 256 to 1,023 lanes), equal word for word to
    ``reduce_block(select_small(p, absd, sgn) flattened, factor)``."""
    w = p[0].shape[1] if absd is None else absd.numel()
    return reduce_block_design(p, factor, w // factor < REDUCE_BLOCK_WIDE_LANES, absd, sgn)


def reduce_block_design(p, factor: int, narrow: bool, absd=None, sgn=None):
    """``reduce_block`` through one of its two designs: ``narrow`` or the
    wide one.  ``reduce_block`` picks by output lanes; the smoke picks."""
    w = p[0].shape[1] if absd is None else absd.numel()
    if factor not in (2, 4, 8) or w % (128 * factor):
        raise ValueError(f"reduce_block: W={w} must be a multiple of 128 * factor, factor in 2/4/8")
    if p[0].device.type == "cpu":
        return reduce_block_plain(p, factor, absd, sgn)
    if absd is None:
        p = tuple(t.contiguous() for t in p)
        dev = _check(*p)
        digits, rows, L, shape = (None, None), 0, 0, f"W={w} f={factor}"
    else:
        batch, rows, L = absd.shape
        p, dev = _check_tables("reduce_block", p, batch * L)
        absd, sgn = _check_digits("reduce_block", absd, sgn, p[0])
        digits = _ptrs(absd, sgn)
        shape = f"W={w} f={factor} tables"
    out = _empty((limb.NLIMB, w // factor), p[0])
    _launch("reduce_block", f"{shape} {_design(narrow)}", dev, *_ptrs(*p), *digits, *_ptrs(*out),
            rows, L, w, factor, int(narrow))
    return out


# ---------------------------------------------------------------------------
# 4. tail_horner: per row 128 lanes -> 1, then Horner over the rows
# ---------------------------------------------------------------------------


def tail_horner_plain(p, rows: int, canonical: bool = False, absd=None, sgn=None):
    """(16, B, rows * 128) -> (16, B).  The 128 lanes of a row halve (t, t
    + 64 first: the order of the Pallas kernel's roll levels), then the
    row sums run through Horner (``horner_plain``, and its ``canonical``).
    With (B, rows, 128) digits, over the points they select from the flat
    tables ``p``."""
    if absd is not None:
        p = tuple(t.reshape(limb.NLIMB, absd.shape[0], -1) for t in _selected(p, absd, sgn))
    batch = p[0].shape[1]
    p = tuple(t.reshape(limb.NLIMB, batch, rows, 128) for t in p)
    width = 128
    while width > 1:
        h = width // 2
        p = curve.padd_loose(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width = h
    rx, ry, rz = curve.tighten3(tuple(t[..., 0] for t in p))
    return horner_plain(rx, ry, rz, canonical)


# tail_horner's first launch (csrc/kernels.cu: tail_rows_kernel, kTailGroup
# and kTailThreads): a block of TAIL_ROWS_THREADS threads a (MSM, row), each
# addition of the row's 128-lane tree on a group of TAIL_ROWS_GROUP threads
# (2 rounds of products); with 32 groups a group runs the first level's
# additions g and g + 32 in turn, then one addition a level
TAIL_ROWS_GROUP = 8
TAIL_ROWS_THREADS = 256


def tail_horner(p, rows: int, canonical: bool = False, absd=None, sgn=None):
    """``tail_horner_plain`` on the card in two launches.  ``canonical``:
    ``horner``'s.  With (B, rows, 128) uint8 digits ``absd`` and ``sgn``,
    ``p`` is table_flat's flat tables of B 128 lanes and the row trees'
    first level gathers the points the digits select (msm's route at 128
    lanes), equal word for word to ``tail_horner(select_small(p, absd,
    sgn), rows)`` reshaped."""
    if absd is None:
        batch, width = p[0].shape[1], p[0].shape[2]
    else:
        batch, width = absd.shape[0], absd.shape[1] * absd.shape[2]
    if width != rows * 128 or (absd is not None and absd.shape[1] != rows):
        raise ValueError(f"tail_horner: lane width {width} != rows * 128")
    if p[0].device.type == "cpu":
        return tail_horner_plain(p, rows, canonical, absd, sgn)
    if absd is None:
        p = tuple(t.contiguous() for t in p)
        dev = _check(*p)
        digits, shape = (None, None), f"K={batch}"
    else:
        p, dev = _check_tables("tail_horner", p, batch * 128)
        absd, sgn = _check_digits("tail_horner", absd, sgn, p[0])
        digits = _ptrs(absd, sgn)
        shape = f"K={batch} tables"
    row_sums = _empty((limb.NLIMB, batch * rows), p[0])  # scratch between the two launches
    planes, out = _horner_out(batch, canonical, p[0])
    _launch("tail_horner", shape + (" canonical" if canonical else ""), dev, *_ptrs(*p), *digits,
            *_ptrs(*row_sums, *planes), batch, rows, int(canonical))
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


# Lanes a call from which table_flat runs its wide design.  On the H100
# (chip_smoke.py phase 2, both designs in turns at TABLE_FLAT_WIDTHS) the
# narrow design took 0.37-0.47 of the wide one's time from 16 to 4,096
# lanes and 0.81 at 8,192; 1.34 at 16,384, 1.17 at 34,816 and 1.54 at
# 65,536, where the wide design's one thread a lane fills the card.
TABLE_FLAT_WIDE_LANES = 16384
# the widths both designs are held and timed at: fold's and the small
# MSMs' tables, cli test's msm_many stack (34 x 1,024) and the bench's
# untabled 65,536
TABLE_FLAT_WIDTHS = (16, 64, 512, 2048, 4096, 8192, 16384, 34816, 65536)


def table_flat(p):
    """Flat tables of (16, N) strict lanes; on the card the narrow design
    under TABLE_FLAT_WIDE_LANES lanes, the wide one from there."""
    return table_flat_design(p, p[0].shape[1] < TABLE_FLAT_WIDE_LANES)


def table_flat_design(p, narrow: bool):
    """``table_flat`` through one of its two designs: ``narrow`` or the
    wide one.  ``table_flat`` picks by lane count; the smoke picks."""
    if p[0].device.type == "cpu":
        return table_flat_plain(p)
    p = tuple(t.contiguous() for t in p)
    dev = _check(*p)
    n = p[0].shape[1]
    tx, tz = (torch.empty((limb.NLIMB * TABLE, n), dtype=torch.int64, device=p[0].device)
              for _ in range(2))
    ty2 = torch.empty((2 * limb.NLIMB * TABLE, n), dtype=torch.int64, device=p[0].device)
    _launch("table_flat", f"L={n} {_design(narrow)}", dev, *_ptrs(*p, tx, ty2, tz), n,
            int(narrow))
    return tx, ty2, tz


def select_plain(tables, absd, sgn):
    """Flat tables of B * L lanes, digits (B, ROWS, L) -> the selected
    entries (16, B, ROWS, L), by direct indexing (three ``torch.gather``:
    also the one PyTorch call the smoke times ``select_small`` against).
    The digits may be uint8 (the kernels' type): ``torch.gather`` takes
    int64 indices, so they are widened here."""
    batch, _, L = absd.shape
    absd, sgn = absd.long(), sgn.long()

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


# Lanes a call (B * L) from which the staged design runs.  On the H100
# (tools/r5_experiments.py H5) it was 2-12% faster than the gather from
# 65,536 lanes a call (one or two MSMs of 65,536; prove's 66 of 2,048, 98
# and 130 of 4,096), within 2% at 16,384 and 32,768, and 2.5x slower at
# 4,096, where 32 blocks stage too few lanes to fill the card.
STAGE_MIN_LANES = 65536


def select_reduce(tables, absd, sgn):
    batch, _, L = absd.shape
    return select_reduce_design(tables, absd, sgn, batch * L >= STAGE_MIN_LANES)


def select_reduce_design(tables, absd, sgn, staged: bool):
    """``select_reduce`` through one of its two designs (``csrc/kernels.cu``):
    ``staged``, each block's lanes' tables in shared memory for all rows, or
    the gather with the rows of a lane block in consecutive blocks.
    ``select_reduce`` picks by lane count; the measurement tools pick."""
    batch, rows, L = absd.shape
    if L % 1024:
        raise ValueError(f"select_reduce: lane count {L} must be a multiple of 1024")
    if tables[0].device.type == "cpu":
        return select_reduce_plain(tables, absd, sgn)
    tables = [t.contiguous() for t in tables]
    dev = _check(*(t.view(-1, limb.NLIMB, batch * L)[0] for t in tables))
    absd, sgn = _check_digits("select_reduce", absd, sgn, tables[0])
    out = _empty((limb.NLIMB, batch * rows * L // 8), tables[0])
    _launch("select_reduce", f"B={batch} L={L} {'staged' if staged else 'rows'}", dev,
            *_ptrs(*tables, absd, sgn, *out), batch, rows, L, int(staged))
    return out


# ---------------------------------------------------------------------------
# 7. fold: per-lane b E + a O with shared digit streams
# ---------------------------------------------------------------------------


def fold_plain(te, to, digits):
    """te, to: the lanes' flat tables (``table_flat``); digits: host (4,
    rows) ints de, se, do, so.  Returns (16, L): per row the sum of the E
    and O entries (E first), then 4 doublings and + that sum (acc first).
    The JAX scan adds the two entries to acc one after the other: the same
    points, other projective words."""
    n = te[0].shape[1]
    d = torch.as_tensor(np.asarray(digits, np.int64)).to(te[0].device)
    return _fold_lanes(te, to, d.unsqueeze(-1).expand(-1, -1, n))


def _fold_lanes(te, to, d):
    """fold's chain over the lanes of the flat tables te, to, lane j's
    entries picked by its own digits d[:, r, j] (d: (4, rows, L) int64)."""
    n = te[0].shape[1]
    acc = curve.identity((n,), te[0].device)

    def entry(t, de, se):
        tx, ty2, tz = (c.view(-1, limb.NLIMB, n) for c in t)
        return tuple(c.gather(0, i.view(1, 1, n).expand(1, limb.NLIMB, n))[0]
                     for c, i in ((tx, de), (ty2, de + TABLE * se), (tz, de)))

    for r in range(d.shape[1]):
        s = curve.padd_loose(entry(te, d[0, r], d[1, r]), entry(to, d[2, r], d[3, r]))
        for _ in range(4):
            acc = curve.pdbl_loose(acc)
        acc = curve.padd_loose(acc, s)
    return curve.tighten3(acc)


def fold_digits(digits) -> bytes:
    """Host digits (4, ROWS) de, se, do, so -> the fold kernel's launch
    argument (``csrc/kernels.cu: FoldDigits``): 4 x 33 bytes, row q at byte
    33 q.  Raises unless there are ``glv.ROWS`` rows of integer magnitudes
    0..8 and signs 0/1."""
    d = np.asarray(digits)
    if (d.shape != (4, glv.ROWS) or not np.issubdtype(d.dtype, np.integer) or d.min() < 0
            or d[0::2].max() > 8 or d[1::2].max() > 1):
        raise ValueError(f"fold digits must be (4, {glv.ROWS}) integers: magnitudes 0..8 and "
                         "signs 0/1")
    return d.astype(np.uint8).tobytes()


def fold(te, to, digits):
    """``fold_plain`` on the card: the digits go to the kernel by value
    (``fold_digits``), so the call neither uploads nor synchronizes.  No
    path calls it: every fold, one prover's too (``msm.fold_mul``), is
    fold_many's, whose tables are built in its launch.  It stays as the
    route fold_many replaced (table_flat x 2 + fold), which the smoke and
    the tests hold fold_many and fold_phi against, word for word, and time
    them beside."""
    packed = ctypes.create_string_buffer(fold_digits(digits), 4 * glv.ROWS)
    if te[0].device.type == "cpu":
        return fold_plain(te, to, digits)
    tabs = [t.contiguous() for t in (*te, *to)]
    n = tabs[0].shape[1]
    dev = _check(*(t.view(-1, limb.NLIMB, n)[0] for t in tabs))
    out = _empty((limb.NLIMB, n), tabs[0])
    _launch("fold", f"L={n}", dev, *_ptrs(*tabs), ctypes.addressof(packed), *_ptrs(*out), n)
    return out


# ---------------------------------------------------------------------------
# 7b. fold_many: fold over B provers at once, each with its own digit streams
# (``jax.vmap(fold_mul_kernel)``, bulletproofspp_tpu/ops/msm.py:297 and :306)
# ---------------------------------------------------------------------------

FOLD_MAX_PROVERS = 16  # provers' digits a launch carries (csrc/kernels.cu)
FOLD_MANY_GROUPS = (8, 16, 32)  # the kernel's group widths, threads a lane
# Lanes a launch from which fold_many runs each lane on a group of 8 threads
# (a warp carries 4 lanes: a quarter of the instructions a lane), and below
# which on 16 (two lanes a warp, each lane's two tables built at once).  On
# an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 2, the three group
# widths in turns): at 32 to 512 lanes 16 and 32 within 0.6% of each other
# and 8 ~25% slower (0.48 against 0.38 ms); at 1,024 lanes 16 the fastest
# (0.394 ms; 8: 0.487, 32: 0.544); at 2,048 lanes 8 (0.491; 16: 0.547, 32:
# 1.16), and at 8,192 (1.22; 16: 2.34, 32: 4.67).
FOLD_MANY_WIDE_LANES = 2048


def fold_many_group(lanes: int) -> int:
    """The group width fold_many takes for a launch of ``lanes`` lanes."""
    return 8 if lanes >= FOLD_MANY_WIDE_LANES else 16


def _prover_lanes(pe, digits, name: str = "fold_many") -> tuple:
    """(B, L): the provers and the lanes of each, whose L lanes lie end to
    end in ``pe``; raises unless digits is (B, 4, ROWS)."""
    d = np.asarray(digits)
    n = pe[0].shape[1]
    if d.ndim != 3 or len(d) < 1 or n % len(d):
        raise ValueError(f"{name}: digits must be (B, 4, {glv.ROWS}) for B provers of equal "
                         f"lane counts, got {d.shape} for {n} lanes")
    return len(d), n // len(d)


def _fold_launches(name: str, pts, packed, lanes: int, group, *out, phi: bool = False):
    """One launch of ``name`` per FOLD_MAX_PROVERS provers over their lanes
    of the (16, B L) planes ``pts``, each with its provers' digits (packed:
    ``fold_digits``) by value and groups of ``group`` threads (None:
    ``fold_many_group`` of its lanes).  With ``phi`` (fold_many only),
    ``pts`` is one basis E and the launch makes its O basis phi(E): null O
    pointers select ``fold_many_kernel<G, true>``."""
    dev = _check(*pts)
    n = pts[0].shape[1]
    if any(t.shape != (limb.NLIMB, n) for t in pts):
        raise ValueError(f"{name} takes its points as (16, B L) planes of one shape")
    ptrs = _ptrs(*pts) + ([0, 0, 0] if phi else [])
    size = FOLD_MAX_PROVERS * 4 * glv.ROWS
    for p0 in range(0, len(packed), FOLD_MAX_PROVERS):
        chunk = packed[p0:p0 + FOLD_MAX_PROVERS]
        g = group or fold_many_group(len(chunk) * lanes)
        buf = ctypes.create_string_buffer(b"".join(chunk), size)
        _launch(name, f"B={len(chunk)} L={lanes} G={g}" + (" phi" if phi else ""), dev, *ptrs,
                ctypes.addressof(buf), *_ptrs(*out), n, lanes, p0 * lanes, len(chunk), g)


def fold_many_plain(pe, po, digits):
    """pe, po: the two bases' (16, B L) strict lanes, B provers' L lanes end
    to end; digits: (B, 4, ROWS) host ints.  ``table_flat_plain`` of each
    basis, then one ``fold_plain`` chain over all B L lanes, each lane's
    entries picked by its prover's digits: the words of ``fold_plain`` per
    prover on its lanes.  Returns (16, B L)."""
    B, L = _prover_lanes(pe, digits)
    te, to = table_flat_plain(pe), table_flat_plain(po)
    d = torch.as_tensor(np.asarray(digits, np.int64)).to(pe[0].device)
    return _fold_lanes(te, to, d.permute(1, 2, 0).repeat_interleave(L, 2))


def fold_many(pe, po, digits):
    """``fold_many_plain`` on the card: one launch per FOLD_MAX_PROVERS
    provers, each prover's digits packed by value (``fold_digits``) into
    the launch, the lanes' tables built in it; the group width by the
    launch's lanes (``fold_many_group``).  At B = 1 its words are
    ``fold(table_flat(pe), table_flat(po), digits[0])``'s: the one-prover
    route (``msm.fold_mul``)."""
    return fold_many_design(pe, po, digits)


def fold_many_design(pe, po, digits, group: int | None = None):
    """``fold_many`` with every launch on groups of ``group`` threads (one
    of FOLD_MANY_GROUPS; None: ``fold_many_group`` of its lanes).  The
    words are the same whatever the group; the smoke times each."""
    _, L = _prover_lanes(pe, digits)
    packed = [fold_digits(d) for d in digits]
    if group is not None and group not in FOLD_MANY_GROUPS:
        raise ValueError(f"fold_many: group {group} is not one of {FOLD_MANY_GROUPS}")
    if pe[0].device.type == "cpu":
        return fold_many_plain(pe, po, digits)
    pts = [t.contiguous() for t in (*pe, *po)]
    out = _empty(pts[0].shape, pts[0])
    _fold_launches("fold_many", pts, packed, L, group, *out)
    return out


def fold_phi_plain(p, digits):
    """``fold_many_plain(p, endo_plain(p), digits)``: per lane b P + a phi(P),
    GLV's k P for k = b + a lambda (``shared_mul``)."""
    return fold_many_plain(p, endo_plain(p), digits)


def fold_phi(p, digits):
    """``fold_phi_plain`` on the card: fold_many's launches (counted as
    fold_many, shape ``"... phi"``) with the O basis phi(p) made in the
    launch, ``endo``'s words (``fold_many_kernel<G, true>``): equal word for
    word to ``fold_many(p, endo(p), digits)``, with no endo launch."""
    _, L = _prover_lanes(p, digits, "fold_phi")
    packed = [fold_digits(d) for d in digits]
    if p[0].device.type == "cpu":
        return fold_phi_plain(p, digits)
    pts = [t.contiguous() for t in p]
    out = _empty(pts[0].shape, pts[0])
    _fold_launches("fold_many", pts, packed, L, None, *out, phi=True)
    return out


# ---------------------------------------------------------------------------
# 7c. complete_square: phi, fold_many's fold and g1 +- r g0 in one launch
# (``complete_square_kernel`` and ``_csq_with_endo``,
# bulletproofspp_tpu/ops/msm.py:283 and :301)
# ---------------------------------------------------------------------------


def complete_square_plain(g0, g1, digits):
    """g0, g1: (16, B L) strict lanes, B provers' L lanes end to end;
    digits: (B, 4, ROWS) host ints de, se, do, so.  The route the kernel
    replaced: rp = ``fold_many_plain(g0, endo_plain(g0), digits)``, then
    (g1 + rp, g1 + (-rp)) by ``padd_plain`` and ``pneg_plain``."""
    rp = fold_many_plain(g0, endo_plain(g0), digits)
    return padd_plain(g1, rp), padd_plain(g1, pneg_plain(rp))


def complete_square(g0, g1, digits):
    """``complete_square_plain`` on the card: one launch per FOLD_MAX_PROVERS
    provers (digits by value, group width ``fold_many_group`` of its lanes),
    which builds each lane's tables of g0 and phi(g0), folds, and stores
    g1 + r g0 and g1 - r g0: equal word for word to endo, fold_many, padd
    and pneg launched one after the other.  Returns (gx, hy), each three
    (16, B L) planes."""
    _, L = _prover_lanes(g0, digits, "complete_square")
    packed = [fold_digits(d) for d in digits]
    if g0[0].device.type == "cpu":
        return complete_square_plain(g0, g1, digits)
    pts = [t.contiguous() for t in (*g0, *g1)]
    gx, hy = _empty(pts[0].shape, pts[0]), _empty(pts[0].shape, pts[0])
    _fold_launches("complete_square", pts, packed, L, None, *gx, *hy)
    return gx, hy


# ---------------------------------------------------------------------------
# 8. select_reduce_fused: table build, select and first 8:1 narrowing in one
# ---------------------------------------------------------------------------


def select_reduce_fused_plain(p, absd, sgn):
    """The two-kernel route's plain versions: table_flat, then select_reduce."""
    return select_reduce_plain(table_flat_plain(p), absd, sgn)


def select_reduce_fused(p, absd, sgn):
    """(16, B * L) strict lanes and digits (B, ROWS, L) -> (16, B * ROWS *
    L / 8) row-major partials, equal limb for limb (before normalization)
    to ``select_reduce(table_flat(p), absd, sgn)``; the lanes' tables are
    built in the kernel's shared memory and never reach device memory."""
    batch, rows, L = absd.shape
    if L % 1024 or p[0].shape[-1] != batch * L:
        raise ValueError(f"select_reduce_fused: {batch} MSMs of L = {L} lanes (a multiple of "
                         f"1024) need {batch * L} point lanes, got {p[0].shape[-1]}")
    if p[0].device.type == "cpu":
        return select_reduce_fused_plain(p, absd, sgn)
    p = tuple(t.contiguous() for t in p)
    dev = _check(*p)
    absd, sgn = _check_digits("select_reduce_fused", absd, sgn, p[0])
    out = _empty((limb.NLIMB, batch * rows * L // 8), p[0])
    _launch("select_reduce_fused", f"B={batch} L={L}", dev, *_ptrs(*p, absd, sgn, *out), batch,
            rows, L)
    return out


# ---------------------------------------------------------------------------
# 9. decompress: y from x and the sign bit, one Fermat square root per lane
# ---------------------------------------------------------------------------


def decompress_plain(x, sign):
    """v = x^3 + 7, r = v^((p+1)/4) (a Fermat chain of ~500 field
    products), ok = r^2 == v, and the root r or -r picked by the sign bit
    (bulletproofspp_tpu/ops/curve.py:225 decompress_kernel); y is defined
    on non-residue lanes too."""
    v = limb.add(limb.mul(limb.mul(x, x), x), limb.const(7, x).expand_as(x))
    r = limb.sqrt_candidate(v)
    ok = limb.eq(limb.mul(r, r), v)
    rn = limb.normalize(r)
    nn = limb.normalize(limb.neg(r))
    big = limb.gt(rn, nn)  # yInt > negYInt
    return limb.select(big == (sign > 0), rn, nn), ok


def decompress(x, sign):
    """x (16, L) canonical, sign (L,) int64 -> (y (16, L) canonical, ok (L,)
    bool)."""
    if x.device.type == "cpu":
        return decompress_plain(x, sign)
    x, sign = x.contiguous(), sign.contiguous()
    dev = _check(x)
    n = x.shape[1]
    if x.dim() != 2 or sign.shape != (n,) or sign.dtype != torch.int64 or sign.device != x.device:
        raise ValueError("decompress takes x (16, L) and sign (L,) int64 on one device")
    y = torch.empty_like(x)
    ok = torch.empty(n, dtype=torch.bool, device=x.device)
    _launch("decompress", f"L={n}", dev, *_ptrs(x, sign, y, ok), n)
    return y, ok


# ---------------------------------------------------------------------------
# 9b. inv and to_affine: the inverse by safegcd divsteps, one thread a lane,
# and the affine conversion of fold_bases / shared_mul
# ---------------------------------------------------------------------------


def inv_plain(a):
    """(16, *batch) strict -> a^-1 mod p canonical, 0 and Q -> 0:
    square-and-multiply over the bits of p - 2 (``limb.fermat_inv``)."""
    return limb.normalize(limb.fermat_inv(a))


def inv(a):
    """``inv_plain`` on the card: Bernstein and Yang's divsteps, 20 batches
    of 30 as libsecp256k1's ``secp256k1_modinv32`` runs them
    (``csrc/field.cuh: fe_inv_divsteps``), on every element; the same
    canonical words (the inverse is unique)."""
    if a.device.type == "cpu":
        return inv_plain(a)
    flat = a.reshape(limb.NLIMB, -1).contiguous()
    dev = _check(flat)
    n = flat.shape[1]
    out = torch.empty_like(flat)
    _launch("inv", f"L={n}", dev, *_ptrs(flat, out), n)
    return out.reshape(a.shape)


def to_affine_plain(x, y, z):
    """(16, L) strict projective lanes -> (x z^-1, y z^-1) canonical and inf
    (L,) bool where z = 0 mod p, x and y 0 there: the JAX package's
    ``curve.to_affine`` (``bulletproofspp_tpu/ops/curve.py:156``), its batch
    inverse ``limb.batch_inv_plain``."""
    zi = limb.batch_inv_plain(z)
    return limb.normalize(limb.mul(x, zi)), limb.normalize(limb.mul(y, zi)), limb.is_zero(z)


def to_affine(x, y, z):
    """``to_affine_plain`` on the card in one launch: one inverse a lane
    (``inv``'s divsteps), then the two products."""
    if x.device.type == "cpu":
        return to_affine_plain(x, y, z)
    x, y, z = (t.contiguous() for t in (x, y, z))
    dev = _check(x, y, z)
    if x.dim() != 2 or y.shape != x.shape or z.shape != x.shape:
        raise ValueError("to_affine takes x, y and z (16, L) planes of one shape")
    n = x.shape[1]
    ax, ay = torch.empty_like(x), torch.empty_like(y)
    inf = torch.empty(n, dtype=torch.bool, device=x.device)
    _launch("to_affine", f"L={n}", dev, *_ptrs(x, y, z, ax, ay, inf), n)
    return ax, ay, inf


# ---------------------------------------------------------------------------
# 9c. the lane-wise functions of the main paths (``csrc/lanes.cu``): the table
# select of MSMs of 128 to 1,023 lanes, endo, pneg and normalize3
# ---------------------------------------------------------------------------


def select_small(tables, absd, sgn):
    """``select_plain`` on the card: one thread a (MSM, row, lane) stores
    the point its uint8 digit selects; equal to it word for word.  No MSM
    route calls it: the launch after it on the route (reduce_lanes,
    reduce_block, tail_horner) selects these words itself.  It stays as
    the unfused route those are held and timed against (``_check_digits``:
    the digits' range is not checked)."""
    if tables[0].device.type == "cpu":
        return select_plain(tables, absd, sgn)
    batch, rows, L = absd.shape
    tables, dev = _check_tables("select_small", tables, batch * L)
    absd, sgn = _check_digits("select_small", absd, sgn, tables[0])
    out = _empty((limb.NLIMB, batch, rows, L), tables[0])
    _launch("select_small", f"B={batch} L={L}", dev, *_ptrs(*tables, absd, sgn, *out), batch,
            rows, L)
    return out


select_small_plain = select_plain  # under the wrapper's name (``engine_profile --plain``)


def endo_plain(p, interleave: bool = False):
    """phi(x, y, z) = (beta x, y, z) over (16, *batch) strict planes; with
    ``interleave``, the (16, ..., 2n) planes of [P_i, phi(P_i)] interleaved
    along the last axis (``bulletproofspp_tpu/ops/engine.py:119``)."""
    x, y, z = p
    e = limb.mul(x, limb.const(ec.BETA, x).expand_as(x)), y, z
    if not interleave:
        return e
    return tuple(torch.stack([a, b], -1).reshape(*a.shape[:-1], -1) for a, b in zip(p, e))


def endo(p, interleave: bool = False):
    """``endo_plain`` on the card in one launch.  The batch axes are
    flattened first: lane k n + i of (16, K, n) planes lands at k 2n + 2i
    and k 2n + 2i + 1, the last axis interleaved."""
    x, y, z = p
    if x.device.type == "cpu":
        return endo_plain(p, interleave)
    flat = [t.reshape(limb.NLIMB, -1).contiguous() for t in (p if interleave else (x,))]
    dev = _check(*flat)
    n = flat[0].shape[1]
    if interleave:
        if any(t.shape != x.shape for t in (y, z)):
            raise ValueError("endo: x, y and z must be planes of one shape")
        out = _empty((limb.NLIMB, 2 * n), flat[0])
        _launch("endo", f"L={n} interleave", dev, *_ptrs(*flat, *out), n, 1)
        return tuple(t.reshape(*x.shape[:-1], 2 * x.shape[-1]) for t in out)
    bx = torch.empty_like(flat[0])
    _launch("endo", f"L={n}", dev, *_ptrs(flat[0], flat[0], flat[0], bx), 0, 0, n, 0)
    return bx.reshape(x.shape), y, z


def pneg_plain(p):
    """(x, -y, z), strict."""
    x, y, z = p
    return x, limb.neg(y), z


def pneg(p):
    """``pneg_plain`` on the card: ``fe_neg`` a lane (strict; -0 may come out
    as 0 or Q, both = 0 mod p)."""
    x, y, z = p
    if y.device.type == "cpu":
        return pneg_plain(p)
    flat = y.reshape(limb.NLIMB, -1).contiguous()
    dev = _check(flat)
    n = flat.shape[1]
    out = torch.empty_like(flat)
    _launch("pneg", f"L={n}", dev, *_ptrs(flat, out), n)
    return x, out.reshape(y.shape), z


def normalize3_plain(x, y, z):
    """Three strict (16, *batch) planes -> canonical (3, 16, *batch), stacked."""
    return torch.stack([limb.normalize(x), limb.normalize(y), limb.normalize(z)])


def normalize3(x, y, z):
    """``normalize3_plain`` on the card in one launch: ``fe_canon`` a lane of
    each plane into one stacked tensor, ready for one device-to-host copy."""
    if x.device.type == "cpu":
        return normalize3_plain(x, y, z)
    if y.shape != x.shape or z.shape != x.shape:
        raise ValueError("normalize3: x, y and z must be planes of one shape")
    flat = [t.reshape(limb.NLIMB, -1).contiguous() for t in (x, y, z)]
    dev = _check(*flat)
    n = flat[0].shape[1]
    out = torch.empty((3, limb.NLIMB, n), dtype=torch.int64, device=x.device)
    _launch("normalize3", f"K={n}", dev, *_ptrs(*flat, out), n)
    return out.reshape(3, *x.shape)


# ---------------------------------------------------------------------------
# 9d. the two device programs around the MSMs: the engine's entry assembly
# (``csrc/lanes.cu``) and the lane tree of MSMs under 128 lanes
# (``csrc/kernels.cu``)
# ---------------------------------------------------------------------------


def _segments_device(outputs):
    """The device of the first segment of any entry; raises if there is none."""
    for entries in outputs:
        for segs in entries:
            for seg in segs:
                return seg[0].device
    raise ValueError("assemble: no segment in any entry")


def assemble_plain(outputs, L: int, interleave: bool = False):
    """``outputs``: S lists of K entries each, an entry a list of (x, y, z)
    segments ((16, n) planes, any strides).  Returns S (x, y, z) of (16, K,
    L) planes: each entry's segments end to end, padded with the identity
    (0 : 1 : 0) to L lanes; with ``interleave`` padded to L / 2 and then
    [P, phi(P)] interleaved by ``endo_plain`` (the identity is its own
    phi).  The engine's eager route: slices, ``torch.cat``, the identity
    pad and ``torch.stack`` (``bulletproofspp_tpu/ops/engine.py:159-220``)."""
    dev = _segments_device(outputs)
    units = L // 2 if interleave else L
    res = []
    for entries in outputs:
        rows = []
        for segs in entries:
            n = sum(seg[0].shape[-1] for seg in segs)
            pad = curve.identity((units - n,), dev)
            rows.append(tuple(torch.cat([seg[c] for seg in segs] + [pad[c]], -1) for c in range(3)))
        planes = tuple(torch.stack([r[c] for r in rows], 1) for c in range(3))
        res.append(endo_plain(planes, interleave=True) if interleave else planes)
    return res


# assemble's segment table travels by value in the launch (csrc/lanes.cu:
# AssembleTable): int32 starts, then one 56-byte record a segment (Seg).
# The library copies it into the smallest of its struct sizes that holds it
# (csrc/lanes.cu: kTiers); the largest is assemble_capacity().
_SEG = np.dtype([("c", "<i8", (3,)), ("rs", "<i4", (3,)), ("ls", "<i4", (3,)), ("n", "<i4"),
                 ("first", "<i4")])

def assemble_capacity() -> int:
    """Bytes of segment table one assemble launch carries (csrc/lanes.cu:
    kMaxTable): 32,712 where the library was built by CUDA 12.1 or later
    (32,764 bytes of kernel parameters), else 4,048."""
    return int(lib()["lanes.cu"].bppp_assemble_capacity())


def _assemble_segments(outputs, units: int) -> list:
    """Each entry's segments, entries in order (output s's entry k is entry
    s K + k): lists of (x, y, z addresses (the first lane's), row strides,
    lane strides, lane count, first lane in the entry); segments of no lanes
    are left out.  Raises unless every entry's segments fit in ``units``
    lanes and every stride and count fits 32 bits."""
    entries = []
    for out in outputs:
        for segs in out:
            off, rows = 0, []
            for x, y, z in segs:
                n = x.shape[-1]
                if x.dim() != 2 or y.dim() != 2 or z.dim() != 2 or y.shape[-1] != n \
                        or z.shape[-1] != n:
                    raise ValueError("assemble: a segment's x, y and z must be (16, n) planes")
                if n:
                    (rx, lx), (ry, ly), (rz, lz) = x.stride(), y.stride(), z.stride()
                    if max(rx, ry, rz, lx, ly, lz, off + n) >= 1 << 31:
                        raise ValueError("assemble: a stride or a lane count past 32 bits")
                    rows.append(((x.data_ptr(), y.data_ptr(), z.data_ptr()), (rx, ry, rz),
                                 (lx, ly, lz), n, off))
                off += n
            if off > units:
                raise ValueError(f"assemble: an entry of {off} lanes does not fit in {units}")
            entries.append(rows)
    return entries


def _table_bytes(n_entries: int, n_segs: int) -> int:
    return (4 * (n_entries + 1) + 7) // 8 * 8 + n_segs * _SEG.itemsize


def _pack_table(entries) -> np.ndarray:
    """One launch's table (csrc/lanes.cu: AssembleTable.bytes) as int64
    words: pairs of int32 starts, then each segment's record (``_SEG``'s
    layout; every 32-bit field is non-negative, so a word is low | high <<
    32).  Built from Python ints in one numpy call: the host's time a call
    is most of a small launch's."""
    starts = [0]
    for rows in entries:
        starts.append(starts[-1] + len(rows))
    if len(starts) % 2:
        starts.append(0)
    words = [starts[i] | starts[i + 1] << 32 for i in range(0, len(starts), 2)]
    for rows in entries:
        for (x, y, z), rs, ls, n, first in rows:
            words += (x, y, z, rs[0] | rs[1] << 32, rs[2] | ls[0] << 32, ls[1] | ls[2] << 32,
                      n | first << 32)
    return np.array(words, dtype=np.int64)


def _assemble_launches(entries, capacity: int) -> list:
    """The launches of one call: [(first entry, entry count, table)] over
    consecutive entries, each table at most ``capacity`` bytes (one launch
    where the whole call's fits)."""
    if _table_bytes(len(entries), sum(len(rows) for rows in entries)) <= capacity:
        return [(0, len(entries), _pack_table(entries))]
    launches, first, n_segs = [], 0, 0
    for e, rows in enumerate(entries):
        if _table_bytes(1, len(rows)) > capacity:
            raise ValueError(f"assemble: an entry of {len(rows)} segments outgrows a launch")
        if _table_bytes(e + 1 - first, n_segs + len(rows)) > capacity:
            launches.append((first, e - first, _pack_table(entries[first:e])))
            first, n_segs = e, 0
        n_segs += len(rows)
    launches.append((first, len(entries) - first, _pack_table(entries[first:])))
    return launches


def assemble(outputs, L: int, interleave: bool = False):
    """``assemble_plain`` on the card (csrc/lanes.cu: assemble_kernel), equal
    to it word for word but for the phi lanes, which equal ``endo``'s words
    (and the plain version's after normalization).  The segments are read
    where they lie, whatever their strides: a slice ``c[:, :n]`` or
    ``bv_split``'s ``c[:, 0::2]`` is not copied first.  Their addresses
    and strides travel by value in the launch (``_assemble_launches``): no
    pinned buffer, no host-to-device copy.  One launch a call, or one a run
    of consecutive entries where the call's table outgrows
    ``assemble_capacity()``.  The S outputs are views of one (S, 16, K, L)
    allocation."""
    S, K = len(outputs), len(outputs[0]) if outputs else 0
    if S == 0 or K == 0 or any(len(entries) != K for entries in outputs):
        raise ValueError("assemble: every output needs the same number K >= 1 of entries")
    if L < 0 or (interleave and L % 2):
        raise ValueError(f"assemble: L = {L} lanes (even with interleave)")
    entries = _assemble_segments(outputs, L // 2 if interleave else L)  # also checks the fit
    where = _segments_device(outputs)
    if where.type == "cpu":
        return assemble_plain(outputs, L, interleave)
    dev = _check(*(c for entries in outputs for segs in entries for seg in segs for c in seg),
                 contiguous=False)
    out = tuple(torch.empty((S, limb.NLIMB, K, L), dtype=torch.int64, device=where)
                for _ in range(3))
    if S * K * L:
        shape = f"S={S} K={K} L={L}{' interleave' if interleave else ''}"
        for first, count, table in _assemble_launches(entries, assemble_capacity()):
            _launch("assemble", shape, dev, table.ctypes.data, table.nbytes, *_ptrs(*out),
                    first, count, K, L, int(interleave))
    return [tuple(c[s] for c in out) for s in range(S)]


def reduce_lanes_tree_plain(p, levels=None):
    """(16, B, rows, L) selected entries, L a power of two -> (16, B, rows)
    row sums: a halving tree (lane t plus lane t + h for h = L / 2, L / 4,
    ..., 1), ``padd_plain`` a level; the JAX package's ``_reduce_lanes``
    adds the same lanes in another order (``bulletproofspp_tpu/ops/msm.py:81``).
    ``levels``: stop after that many levels, lane 0's partial sums."""
    width, level = p[0].shape[-1], 0
    while width > 1 and (levels is None or level < levels):
        h = width // 2
        p = padd_plain(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width, level = h, level + 1
    return tuple(t[..., 0] for t in p)


def reduce_lanes_plain(tables, absd, sgn, levels=None):
    """Flat tables of B L lanes and (B, rows, L) digits -> (16, B, rows) row
    sums: ``reduce_lanes_tree_plain(select_plain(tables, absd, sgn))``, the
    JAX package's one-hot select and ``_reduce_lanes`` (``msm.py:140-176``)
    in the padd tree's order."""
    return reduce_lanes_tree_plain(select_plain(tables, absd, sgn), levels)


def _levels(L: int, levels) -> int:
    full = L.bit_length() - 1
    if levels is not None and not 1 <= levels <= full:
        raise ValueError(f"reduce_lanes: levels = {levels} outside 1..{full}")
    return full if levels is None else levels


def _lane_width(L: int, shape) -> None:
    if L < 2 or L >= 128 or L & (L - 1):
        raise ValueError(f"reduce_lanes: L a power of two in [2, 128), got {tuple(shape)}")


def reduce_lanes(tables, absd, sgn, levels=None):
    """``reduce_lanes_plain`` on the card in one launch (csrc/kernels.cu:
    reduce_lanes_kernel), 2 <= L < 128: the first level gathers its operands
    by digit from the tables, then the same additions in the same order as
    the padd kernel's halving tree, so the words equal ``select_small`` and
    that route's.  ``levels`` (the smoke's per-level timing): stop after
    that many levels.  The digits' range is not checked (``_check_digits``)."""
    batch, rows, L = absd.shape
    _lane_width(L, absd.shape)
    lv = _levels(L, levels)
    if tables[0].device.type == "cpu":
        return reduce_lanes_plain(tables, absd, sgn, levels)
    tables, dev = _check_tables("reduce_lanes", tables, batch * L)
    absd, sgn = _check_digits("reduce_lanes", absd, sgn, tables[0])
    out = _empty((limb.NLIMB, batch, rows), tables[0])
    _launch("reduce_lanes", f"B={batch} L={L}" + (f" levels={lv}" if levels else ""), dev,
            *_ptrs(*tables, absd, sgn, *out), batch, rows, L, lv, 1)
    return out


def reduce_lanes_tree(p, levels=None):
    """``reduce_lanes_tree_plain`` on the card: the reduce_lanes kernel with
    its first-level operands read from (16, B, rows, L) planes (the tree
    alone, which the smoke holds the fused route against)."""
    L = p[0].shape[-1]
    if p[0].dim() != 4:
        raise ValueError(f"reduce_lanes: (16, B, rows, L) planes, got {tuple(p[0].shape)}")
    _lane_width(L, p[0].shape)
    lv = _levels(L, levels)
    if p[0].device.type == "cpu":
        return reduce_lanes_tree_plain(p, levels)
    p = tuple(t.contiguous() for t in p)
    dev = _check(*p)
    batch, rows = p[0].shape[1:3]
    out = _empty((limb.NLIMB, batch, rows), p[0])
    _launch("reduce_lanes", f"B={batch} L={L} tree" + (f" levels={lv}" if levels else ""), dev,
            *_ptrs(*p), 0, 0, *_ptrs(*out), batch, rows, L, lv, 0)
    return out


# ---------------------------------------------------------------------------
# 10. sr_variant: select_reduce with block blk and output width out_w
# ---------------------------------------------------------------------------


def _halve(p, width: int, out_w: int):
    """Halving complete adds over the last axis (first half + second half)
    until ``out_w`` lanes are left; loose out."""
    while width > out_w:
        h = width // 2
        p = curve.padd_loose(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width = h
    return p


def sr_variant_plain(tables, absd, sgn, blk: int = 1024, out_w: int = 128, noselect: bool = False):
    """Flat tables of L lanes, digits (rows, L) -> (16, rows * L * out_w /
    blk) in (row, block, lane) order: each row's blocks of ``blk`` selected
    entries halve to ``out_w`` lanes (``tools/r5_experiments.py:
    _sr_kernel``).  ``noselect`` takes entry 1 (+Y) for every (row, lane)
    (``_sr_kernel_noselect``)."""
    rows, L = absd.shape
    if noselect:
        absd, sgn = torch.ones_like(absd), torch.zeros_like(sgn)
    sel = select_plain(tables, absd[None], sgn[None])  # (16, 1, rows, L)
    sel = tuple(t.reshape(limb.NLIMB, rows, L // blk, blk) for t in sel)
    return tuple(t.reshape(limb.NLIMB, -1) for t in curve.tighten3(_halve(sel, blk, out_w)))


def sr_variant(tables, absd, sgn, blk: int = 1024, out_w: int = 128, noselect: bool = False):
    """``sr_variant_plain`` on the card: select_reduce's staged row phase
    (``csrc/select_reduce.cuh``) at F = blk / out_w and this geometry, one
    MSM; at blk 1,024 / out 128 the words of ``select_reduce``."""
    rows, L = absd.shape
    if out_w <= 0 or blk % out_w or blk // out_w not in (2, 4, 8, 16) or L % blk:
        raise ValueError(f"sr_variant: blk {blk} / out_w {out_w} must be 2, 4, 8 or 16 and "
                         f"divide L = {L} into blocks")
    if tables[0].device.type == "cpu":
        return sr_variant_plain(tables, absd, sgn, blk, out_w, noselect)
    tables = [t.contiguous() for t in tables]
    dev = _check(*(t.view(-1, limb.NLIMB, L)[0] for t in tables))
    absd, sgn = _check_digits("sr_variant", absd, sgn, tables[0])
    out = _empty((limb.NLIMB, rows * L * out_w // blk), tables[0])
    _launch("sr_variant", f"L={L} blk={blk} out={out_w}", dev, *_ptrs(*tables, absd, sgn, *out),
            rows, L, blk, out_w, int(noselect))
    return out


# ---------------------------------------------------------------------------
# 11. grid_copy: x + 1 (mod 2^32), written once per row
# ---------------------------------------------------------------------------


def grid_copy_plain(x, rows: int = 33):
    """(16, L) -> (16, rows * L): (x + 1) mod 2^32, repeated per row."""
    return ((x + 1) & 0xFFFFFFFF).repeat(1, rows)


def grid_copy(x, blk: int = 1024, rows: int = 33):
    """``tools/r5_experiments.py: grid_copy``: one block per (lane block of
    ``blk``, row) on the card."""
    L = x.shape[-1]
    if x.dim() != 2 or blk <= 0 or blk % 2 or L % blk:
        raise ValueError(f"grid_copy: x must be (16, L) with L a multiple of blk = {blk} (even)")
    if x.device.type == "cpu":
        return grid_copy_plain(x, rows)
    x = x.contiguous()
    dev = _check(x)
    out = torch.empty((limb.NLIMB, rows * L), dtype=torch.int64, device=x.device)
    _launch("grid_copy", f"L={L}", dev, *_ptrs(x, out), L, rows, blk)
    return out


# ---------------------------------------------------------------------------
# 12. chain: one phase of the complete add, chained per lane
# ---------------------------------------------------------------------------


def _carry(cols):
    """(K, ...) nonnegative int64 columns (< 2^62) -> K strict limbs of
    their value mod 2^(16 K): an exact sequential carry."""
    out = torch.empty_like(cols)
    c = torch.zeros_like(cols[0])
    for i in range(cols.shape[0]):
        v = cols[i] + c
        out[i] = v & limb.MASK
        c = v >> limb.LBITS
    return out


def _product(a, b):
    """Strict a, b -> the 32 strict limbs of the integer product a * b."""
    batch = a.shape[1:]
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape(limb.NLIMB * limb.NLIMB, *batch)
    cols = torch.zeros((2 * limb.NLIMB, *batch), dtype=torch.int64, device=a.device)
    cols.index_add_(0, limb._col_index(a.device), prod)
    return _carry(cols)


def _mul_unfolded(x, b):
    """The product reduced by one pass L + 977 H + 2^32 H, mod 2^256 (the
    carry out of 2^256 dropped): ``tools.cu: fe_mul_unfolded``."""
    t = _product(x, b)
    lo, hi = t[: limb.NLIMB], t[limb.NLIMB :]
    s = lo + limb.C_LOW * hi
    s[2:] += hi[:-2]
    return _carry(s)


def _fold_words(r, c):
    """``field.cuh: fe_fold``: r + c (2^32 + 977), c < 2^35, and where that
    carries out of 2^256, 2^32 + 977 once more on its low 256 bits."""
    v = torch.zeros((limb.NLIMB + 1, *r.shape[1:]), dtype=torch.int64, device=r.device)
    v[: limb.NLIMB] = r
    m = c * limb.C_LOW
    v[0] += m & limb.MASK
    v[1] += (m >> 16) & limb.MASK
    v[2] += (m >> 32) + (c & limb.MASK)
    v[3] += (c >> 16) & limb.MASK
    v[4] += c >> 32
    v = _carry(v)
    r, o = v[: limb.NLIMB], v[limb.NLIMB]
    r[0] += o * limb.C_LOW
    r[2] += o
    return _carry(r)


def _sub_c(r, o):
    """``field.cuh: fe_sub_c``: r - o (2^32 + 977) mod 2^256, o in {0, 1},
    and the borrow out of 2^256."""
    v = torch.cat([r, torch.ones_like(r[:1])])  # + 2^256: the borrow is 1 - the top limb
    v[0] -= o * limb.C_LOW
    v[2] -= o
    v = _carry(v)
    return v[: limb.NLIMB], 1 - v[limb.NLIMB]


def _reduce_words(t):
    """``field.cuh: fe_reduce512`` of the 32 strict limbs t of a 512-bit
    product: one pass S = L + 977 H + 2^32 H, then ``fe_fold`` of S's carry."""
    n = limb.NLIMB
    lo, hi = t[:n], t[n:]
    s = torch.zeros((n + 3, *t.shape[1:]), dtype=torch.int64, device=t.device)
    s[:n] = lo + limb.C_LOW * hi
    s[2 : n + 2] += hi
    s = _carry(s)
    return _fold_words(s[:n], s[n] + (s[n + 1] << 16) + (s[n + 2] << 32))


def _split_product(x, b):
    """``curve_warp.cuh: fe_mul_split``'s 512-bit product, limb for limb: thread
    2j forms x times b's low 128 bits and thread 2j + 1 x times its high 128
    (``fe_mul_half``: 24 limbs each); the second is added at limb 8 (word
    4) by a carry chain over the 32 limbs of the 512-bit product."""
    h = limb.NLIMB // 2
    low = torch.cat([b[:h], torch.zeros_like(b[h:])])
    high = torch.cat([b[h:], torch.zeros_like(b[h:])])
    p0, p1 = _product(x, low), _product(x, high)
    cols = p0.clone()
    cols[h:] += p1[:-h]
    return _carry(cols)


def field_words(op: str, x, b):
    """The exact words (as strict 16-bit limbs) that ``csrc/field.cuh``
    returns for ``fe_mul`` ("mul"), ``fe_add`` ("add") and ``fe_sub``
    ("sub") of strict (16, ...) limbs: its representative, not only its
    value mod p.  mul: one pass S = L + 977 H + 2^32 H over the product L +
    2^256 H, then ``fe_fold`` of S's carry; "mul_split": the same reduction
    of the product formed as ``fe_mul_split`` forms it
    (``_split_product``: two halves on two threads, added at word 4), which
    must be fe_mul's words; add: the sum's carry folded; sub: the
    difference, then C subtracted on each borrow, at most twice.  Exact
    integer arithmetic on int64 limbs; ``chip_smoke.py`` holds the chain
    kernel's mul_f16, add and sub phases to it raw."""
    if op == "mul":
        return _reduce_words(_product(x, b))
    if op == "mul_split":
        return _reduce_words(_split_product(x, b))
    n = limb.NLIMB
    if op == "add":
        s = _carry(torch.cat([x + b, torch.zeros_like(x[:1])]))
        return _fold_words(s[:n], s[n])
    if op == "sub":
        r, borrow = _sub_c(x - b, torch.zeros_like(x[0]))
        r, borrow = _sub_c(r, borrow)
        return _sub_c(r, borrow)[0]
    raise ValueError(f"field_words: no operation {op!r}")


# name -> (phase index of tools.cu, state planes, value phase).  Value
# phases are equal mod p to the JAX bodies of tools/phase_bench.py; the
# limb-form phases (mul_w16, carry_full, prod_form) run the port's nearest
# step of its own arithmetic and have no JAX value to hold.
CHAIN_PHASES = {
    "padd": (0, 3, True),
    "mul_w16": (1, 1, False),
    "mul_f16": (2, 1, True),
    "mul_small": (3, 1, True),
    "add": (4, 1, True),
    "add_s17": (5, 1, True),
    "sub": (6, 1, True),
    "sub_raw2": (7, 1, True),
    "carry_full": (8, 1, False),
    "prod_form": (9, 1, False),
}

_CHAIN_STEP = {
    "mul_w16": _mul_unfolded,
    "mul_f16": limb.mul,
    "mul_small": lambda x, b: limb.mul_small(x, 3),
    "add": limb.add,
    "add_s17": limb.add,
    "sub": limb.sub,
    "sub_raw2": lambda x, b: limb.sub(x, limb.add(b, b)),
    "carry_full": lambda x, b: limb.normalize(limb.add(limb.add(x, x), b)),
    "prod_form": lambda x, b: _product(x, b)[: limb.NLIMB],
}


def chain_plain(phase: str, a, b, rep: int = 8):
    """x <- step(x, b) ``rep`` times; returns the first state plane."""
    if phase == "padd":
        x = a
        for _ in range(rep):
            x = padd_plain(x, b)
        return x[0]
    x = a[0]
    for _ in range(rep):
        x = _CHAIN_STEP[phase](x, b[0])
    return x


def chain(phase: str, a, b, rep: int = 8):
    """``tools/phase_bench.py: make_chain(body).run`` for one phase of
    ``CHAIN_PHASES``: a, the state (``nstate`` (16, L) planes), b three
    (16, L) planes (padd reads all three, the others b[0])."""
    idx, nstate, _ = CHAIN_PHASES[phase]
    if len(a) != nstate or len(b) != 3:
        raise ValueError(f"chain {phase}: {nstate} state planes and 3 b planes")
    if a[0].device.type == "cpu":
        return chain_plain(phase, a, b, rep)
    a = [t.contiguous() for t in a]
    b = [t.contiguous() for t in b]
    dev = _check(*a, *b)
    n = a[0].shape[1]
    if any(t.shape != (limb.NLIMB, n) for t in (*a, *b)):
        raise ValueError("chain planes must all be (16, L)")
    a = a + [a[0]] * (3 - nstate)
    out = torch.empty_like(a[0])
    _launch("chain", f"L={n}", dev, idx, *_ptrs(*a, *b, out), n, rep, 0)
    return out


# The rounds of the point chains as phases of the chain kernel
# (``csrc/tools.cu: round_kernel``): name -> (phase index, addition, G, S).
# The state is a point, b a point: x <- x + b (addition) or 2 x each step, a
# lane on a group of G threads, in ``csrc/curve_warp.cuh``'s rounds, each
# product on S threads (S = 2: ``fe_mul_split``).  G = 16: "warp" (S = 1)
# and "split" (S = 2, fold_rows'); G = 32: horner's, S = 1 (before its
# split) and 2 (HORNER_SPLIT); G = 8, S = 1: the narrow kernels' and
# tail_rows' additions (TAIL_ROWS_GROUP); "add_pair": fold_rows' paired
# addition, G = 16 whose halves of 8 each add at S = 1 (half 0 x + b, half 1
# b + x) and trade their sums by shuffles (``curve_warp.cuh: pt_add_pair``),
# the state half 0's sum.
ROUND_PHASES = {
    "add_warp": (10, True, 16, 1), "dbl_warp": (11, False, 16, 1),
    "add_split": (12, True, 16, 2), "dbl_split": (13, False, 16, 2),
    "add_g32_s1": (14, True, 32, 1), "dbl_g32_s1": (15, False, 32, 1),
    "add_g32_s2": (16, True, 32, 2), "dbl_g32_s2": (17, False, 32, 2),
    "add_g8_s1": (18, True, 8, 1), "add_pair": (19, True, 16, 1),
}
# the threads each product of horner's rounds runs on (csrc/kernels.cu:
# kHornerSplit)
HORNER_SPLIT = 2
# curve_warp.cuh: RoundPart, the parts round_chain's clocks sum
ROUND_PARTS = ("form", "product", "combine", "broadcast", "steps")


def round_chain_plain(phase: str, a, b, rep: int = 8):
    """x <- x + b (``padd_plain``) or 2 x (``curve.pdbl``) ``rep`` times;
    returns the first state plane."""
    add = ROUND_PHASES[phase][1]
    x = tuple(a)
    for _ in range(rep):
        x = padd_plain(x, b) if add else curve.pdbl(x)
    return x[0]


def round_chain(phase: str, a, b, rep: int = 8, clocks=None):
    """``round_chain_plain`` on the card through the chain kernel, a lane on
    a group of G threads (ROUND_PHASES: which rounds, G and S).  a, b: three (16, L)
    planes each.  ``clocks``: None, or a (len(ROUND_PARTS), L) int64 tensor
    on the card that receives, a lane, the SM cycles each part of its
    rounds took over the ``rep`` steps (``clock64`` in the kernel; the card
    only)."""
    idx = ROUND_PHASES[phase][0]
    if len(a) != 3 or len(b) != 3:
        raise ValueError(f"round_chain {phase}: 3 state planes and 3 b planes")
    if a[0].device.type == "cpu":
        return round_chain_plain(phase, a, b, rep)
    a = [t.contiguous() for t in a]
    b = [t.contiguous() for t in b]
    dev = _check(*a, *b)
    n = a[0].shape[1]
    if any(t.shape != (limb.NLIMB, n) for t in (*a, *b)):
        raise ValueError("round_chain planes must all be (16, L)")
    if clocks is not None and (clocks.shape != (len(ROUND_PARTS), n) or clocks.dtype != torch.int64
                               or clocks.device != dev or not clocks.is_contiguous()):
        raise ValueError(f"round_chain clocks must be a contiguous ({len(ROUND_PARTS)}, {n}) "
                         "int64 tensor on the planes' device")
    out = torch.empty_like(a[0])
    _launch("chain", f"L={n} {phase}", dev, idx, *_ptrs(*a, *b, out), n, rep,
            0 if clocks is None else clocks.data_ptr())
    return out
