"""GLV/Straus multi-scalar multiplication, basis folding and square completion.

The port of ``bulletproofspp_tpu/ops/msm.py``.  Scalars arrive GLV-split
and recoded on the host (``ops.glv`` / ``native``) as 33 signed base-16
digit rows per lane; each lane's multiples 0P..8P and their negated Y come
from the table_flat kernel, and every (row, lane) picks its entry by
direct indexing (a Hopper GPU gathers natively, so the TPU's one-hot
select is not carried over) in the first level of the launch that sums
it: reduce_lanes under 128 lanes, reduce_block or tail_horner from 128 to
1,023, select_reduce from there; the selected points never reach device
memory.  They are summed over lanes and the 33 row sums combined by
Horner, by lane count L as in the JAX package (``msm.py:105-196``):

  * under 128 lanes: the select and the lane tree of each row in one
    reduce_lanes launch (the halving order: lane t plus lane t + L/2, ...;
    the JAX package compiles its select and ``_reduce_lanes`` into one
    program too), then the horner kernel;
  * 128 to 512 lanes: the reduce_block chain (8:1 per launch, its first
    launch selecting from the tables) down to 128 lanes per row, then
    tail_horner (at 128 lanes its row trees select);
  * from 1,024 lanes: the select_reduce kernel (select and the first 8:1
    narrowing in one launch), then the same chain and tail_horner;
  * from SCRATCH_TABLE_MIN_L = 2^21 lanes: the select_reduce_fused
    kernel instead of table_flat + select_reduce, so the flat tables
    (4,608 B a lane as int64 planes, 9.7 GB at 2^21 lanes) are never
    materialised, as ``msm.py:123-129`` does on the TPU.

Everything is batched over a leading MSM axis B (``msm_many``'s K stacked
MSMs; the JAX package vmaps instead).  Planes: (16, B, L) points and
(B, ROWS, L) uint8 digits.  With ``canonical`` the route's last launch
(horner's warp) stores the result as one stacked canonical (3, 16, B)
tensor, ``normalize3``'s words, as ``_msm_many_norm`` compiles
``curve._normalize3`` into the MSM's program
(``bulletproofspp_tpu/ops/engine.py:223-239``): no launch of its own.

For a FIXED basis (the bench's, ``bulletproofspp_tpu_torch.bench``) the
multiple tables are pure precomputation: ``precompute_flat_table`` builds
them once and ``msm_tabled`` runs the rest, 33 complete adds a lane
instead of 40 (``msm.py:199-244``).  The engine's own MSMs do not use it:
their bases change as the argument folds.
"""

from __future__ import annotations

import numpy as np

from . import curve, kernels, limb

SCRATCH_TABLE_MIN_L = 1 << 21  # bulletproofspp_tpu/ops/msm.py:52


def _flat(p):
    return tuple(t.reshape(limb.NLIMB, -1) for t in p)


def msm(px, py, pz, absd, sgn, canonical: bool = False):
    """sum_i s_i P_i per batch entry.  px/py/pz: (16, B, L) projective
    lanes, L a power of two (identity lanes encode None and padding);
    absd/sgn: (B, ROWS, L) uint8 digit magnitudes [0..8] and signs {0, 1}.
    Returns projective (16, B) planes, or with ``canonical`` the stacked
    canonical (3, 16, B) tensor ``curve.normalize3`` would make of them."""
    batch, L = px.shape[1:]
    if L & (L - 1):
        raise ValueError(f"lane count {L} must be a power of two")
    rows = absd.shape[1]
    p = _flat((px, py, pz))
    if L >= SCRATCH_TABLE_MIN_L:
        return _narrow(kernels.select_reduce_fused(p, absd, sgn), L // 8, batch, rows, canonical)
    if L >= 1024:
        return msm_tabled(kernels.table_flat(p), absd, sgn, canonical)
    if L < 128:
        return kernels.horner(*kernels.reduce_lanes(kernels.table_flat(p), absd, sgn),
                              canonical=canonical)
    return _narrow(kernels.table_flat(p), L, batch, rows, canonical, absd, sgn)


def _narrow(flat, width: int, batch: int, rows: int, canonical: bool = False, absd=None,
            sgn=None):
    """Row-major partials of ``width`` lanes a row -> (16, B) sums: the
    reduce_block chain (8:1 per launch) to 128 lanes, then tail_horner
    (``canonical``: its).  With digits, ``flat`` is the flat tables and the
    partials the points the digits select: the first launch gathers them."""
    digits = {} if absd is None else {"absd": absd, "sgn": sgn}
    while width > 128:
        f = min(8, width // 128)
        flat = kernels.reduce_block(flat, f, **digits)
        digits = {}
        width //= f
    if not digits:
        flat = tuple(t.reshape(limb.NLIMB, batch, rows * 128) for t in flat)
    return kernels.tail_horner(flat, rows, canonical=canonical, **digits)


def tabled_supported(L: int) -> bool:
    """Lane counts the tabled route takes (``msm.py:232-244``): a power of
    two with 1,024 <= L < SCRATCH_TABLE_MIN_L.  From 2^21 lanes the flat
    table (4,608 B a lane) is the footprint select_reduce_fused avoids."""
    return 1024 <= L < SCRATCH_TABLE_MIN_L and (L & (L - 1)) == 0


def precompute_flat_table(px, py, pz):
    """Flat multiple tables of a FIXED basis of B * L lanes, to be kept
    across MSM calls: (144, N), (288, N), (144, N) int64 planes (the
    table_flat kernel, ``msm.py:199``)."""
    return kernels.table_flat(_flat((px, py, pz)))


def msm_tabled(tables, absd, sgn, canonical: bool = False):
    """``msm`` with the table build hoisted out (``msm_tabled_kernel``,
    ``msm.py:215``): select_reduce, the reduce_block chain and tail_horner.
    tables: ``precompute_flat_table``'s; absd/sgn (B, ROWS, L) uint8.
    Returns projective (16, B) planes, or ``msm``'s ``canonical`` tensor."""
    batch, rows, L = absd.shape
    if not tabled_supported(L):
        raise ValueError(f"msm_tabled: L = {L} lanes is outside the tabled route")
    return _narrow(kernels.select_reduce(tables, absd, sgn), L // 8, batch, rows, canonical)


def fold_mul(pe, po, de, se, do, so):
    """Per-lane b E_i + a O_i with SHARED digit streams
    (``bulletproofspp_tpu/ops/msm.py:247`` fold_mul_kernel).

    pe, po: (16, L) strict projective lanes (identity encodes None);
    de/se, do/so: host digit rows (ROWS,) of the scalars for E and O.
    The tables come from the table_flat kernel, the 33 rows from the fold
    kernel."""
    return kernels.fold(kernels.table_flat(pe), kernels.table_flat(po), np.stack([de, se, do, so]))


def run_fold(pe, po, de, se, do, so):
    """``fold_mul``, then the lanes to affine on the device
    (``bulletproofspp_tpu/ops/msm.py:313-321``): (x, y, inf) of
    ``curve.to_affine``."""
    return curve.to_affine(fold_mul(pe, po, de, se, do, so))


def fold_mul_many(pe, po, digits):
    """``fold_mul`` for B provers at once (``jax.vmap(fold_mul_kernel)``,
    ``bulletproofspp_tpu/ops/msm.py:297``): pe, po (16, B L) lanes, prover
    b's L lanes at b L; digits (B, 4, ROWS) host rows de, se, do, so of each
    prover.  One fold_many launch (a launch per 16 provers), which builds
    the lanes' tables itself, as ``fold_mul_kernel`` does: no table_flat
    launch."""
    return kernels.fold_many(pe, po, digits)


def complete_square(g0, g1, de, se, do, so):
    """(g1 + r g0, g1 - r g0) lanes with r g0 through the GLV halves
    (g0, phi(g0)) and shared digit streams
    (``bulletproofspp_tpu/ops/msm.py:283`` complete_square_kernel, after
    the endomorphism, ``ops/engine.py:41``): one complete_square launch."""
    return kernels.complete_square(g0, g1, np.stack([de, se, do, so])[None])


def complete_square_many(g0, g1, digits):
    """``complete_square`` for B provers at once (``jax.vmap(_csq_with_endo)``,
    ``bulletproofspp_tpu/ops/msm.py:306``): g0, g1 (16, B L), digits (B, 4,
    ROWS).  One complete_square launch a 16 provers: phi, the fold (each
    lane's tables built in the launch) and both additions."""
    return kernels.complete_square(g0, g1, digits)
