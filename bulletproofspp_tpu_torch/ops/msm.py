"""GLV/Straus multi-scalar multiplication, basis folding and square completion.

The port of ``bulletproofspp_tpu/ops/msm.py``.  Scalars arrive GLV-split
and recoded on the host (``ops.glv`` / ``native``) as 33 signed base-16
digit rows per lane; each lane's multiples 0P..8P and their negated Y come
from the table_flat kernel, and every (row, lane) picks its entry by
direct indexing (a Hopper GPU gathers natively, so the TPU's one-hot
select is not carried over).  The selected points are summed over lanes
and the 33 row sums combined by Horner, by lane count L as in the JAX
package (``msm.py:105-196``):

  * under 128 lanes: a halving lane tree through the padd kernel, then
    the horner kernel;
  * 128 to 512 lanes: the reduce_block chain (8:1 per launch) down to 128
    lanes per row, then tail_horner;
  * from 1,024 lanes: the select_reduce kernel (select and the first 8:1
    narrowing in one launch), then the same chain and tail_horner.

Everything is batched over a leading MSM axis B (``msm_many``'s K stacked
MSMs; the JAX package vmaps instead).  Planes: (16, B, L) points and
(B, ROWS, L) int64 digits.
"""

from __future__ import annotations

import numpy as np

from . import curve, kernels, limb


def _flat(p):
    return tuple(t.reshape(limb.NLIMB, -1) for t in p)


def msm(px, py, pz, absd, sgn):
    """sum_i s_i P_i per batch entry.  px/py/pz: (16, B, L) projective
    lanes, L a power of two (identity lanes encode None and padding);
    absd/sgn: (B, ROWS, L) int64 digit magnitudes [0..8] and signs {0, 1}.
    Returns projective (16, B) planes."""
    batch, L = px.shape[1:]
    if L & (L - 1):
        raise ValueError(f"lane count {L} must be a power of two")
    rows = absd.shape[1]
    tables = kernels.table_flat(_flat((px, py, pz)))
    if L >= 1024:
        flat, width = kernels.select_reduce(tables, absd, sgn), L // 8
    else:
        sel = kernels.select_plain(tables, absd, sgn)
        if L < 128:
            width = L
            while width > 1:
                h = width // 2
                sel = curve.padd(tuple(t[..., :h] for t in sel), tuple(t[..., h:] for t in sel))
                width = h
            return kernels.horner(*(t[..., 0] for t in sel))
        flat, width = _flat(sel), L
    while width > 128:
        f = min(8, width // 128)
        flat = kernels.reduce_block(flat, f)
        width //= f
    return kernels.tail_horner(tuple(t.reshape(limb.NLIMB, batch, rows * 128) for t in flat), rows)


def fold_mul(pe, po, de, se, do, so):
    """Per-lane b E_i + a O_i with SHARED digit streams
    (``bulletproofspp_tpu/ops/msm.py:247`` fold_mul_kernel).

    pe, po: (16, L) strict projective lanes (identity encodes None);
    de/se, do/so: host digit rows (ROWS,) of the scalars for E and O.
    The tables come from the table_flat kernel, the 33 rows from the fold
    kernel."""
    return kernels.fold(kernels.table_flat(pe), kernels.table_flat(po), np.stack([de, se, do, so]))


def complete_square(g0, g1, de, se, do, so):
    """(g1 + r g0, g1 - r g0) lanes with r g0 through the GLV halves
    (g0, phi(g0)) and shared digit streams
    (``bulletproofspp_tpu/ops/msm.py:283`` complete_square_kernel)."""
    rp = fold_mul(g0, curve.endo(g0), de, se, do, so)
    return curve.padd(g1, rp), curve.padd(g1, curve.pneg(rp))
