"""Batched secp256k1 group law with complete projective formulas (PyTorch).

The algebra of ``bulletproofspp_tpu/ops/curve.py:34-83``: Renes-Costello-
Batina complete addition and doubling for a = 0, b3 = 21, over
homogeneous projective (X:Y:Z) with identity (0:1:0).  One branchless
stream handles P+Q, P+P, P+(-P), P+O and O+Q.  Points are tuples of
(16, *batch) int64 limb planes (``ops.limb``).

``padd``, ``pneg``, ``endo``, ``normalize3``, ``decompress`` and
``to_affine`` are public entries: on a CUDA tensor they launch the
hand-written kernel (``ops.kernels.padd``, ``.pneg``, ...), on a CPU
tensor they run its plain version.  The ``*_loose`` forms keep lazy limbs between
point operations (``ops.limb`` forms); loops that chain many point ops
(Horner, basis folding) use them and tighten once at the end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.fields import Q
from . import limb

B3 = 21


def identity(batch, device):
    """The point at infinity (0 : 1 : 0)."""
    return limb.zeros(batch, device), limb.ones(batch, device), limb.zeros(batch, device)


def padd_loose(p, q):
    """RCB complete addition (2015, Algorithm 7, a = 0).  Inputs: limbs
    < 2^18 (strict planes or loose outputs); outputs loose.  Bounds per step (limb maxima): sums of
    two inputs < 2^19; products loose (~2^16); t3/t4/t5 and t1m, as
    subtractions, < 2^24; t2b = 21 * t2 < 2^22 (a valid subtrahend);
    t5 is loosened before its multiple by 21."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    m, s = limb.mul_loose, limb.sub_raw

    t0 = m(x1, x2)
    t1 = m(y1, y2)
    t2 = m(z1, z2)
    t3 = s(m(x1 + y1, x2 + y2), t0 + t1)  # X1Y2 + X2Y1
    t4 = s(m(y1 + z1, y2 + z2), t1 + t2)  # Y1Z2 + Y2Z1
    t5 = s(m(x1 + z1, x2 + z2), t0 + t2)  # X1Z2 + X2Z1
    t0_3 = 3 * t0
    t2b = B3 * t2
    z3t = t1 + t2b
    t1m = s(t1, t2b)
    y3b = B3 * limb.loosen(t5, limb.MUL_IN_MAX)
    x3 = s(m(t3, t1m), m(t4, y3b))
    y3 = m(y3b, t0_3) + m(t1m, z3t)
    z3 = m(z3t, t4) + m(t0_3, t3)
    return (
        limb.loosen(x3, limb.MUL_IN_MAX),
        limb.loosen(y3, 2 * limb.LOOSE_MAX),
        limb.loosen(z3, 2 * limb.LOOSE_MAX),
    )


def pdbl_loose(p):
    """RCB complete doubling (2015, Algorithm 9, a = 0); same forms as
    ``padd_loose``.  The subtrahend 3 * t2 = 63 * z^2 stays < SUB_W."""
    x, y, z = p
    m = limb.mul_loose

    t0 = m(y, y)
    z3 = 8 * t0
    t1 = m(y, z)
    t2 = B3 * m(z, z)
    x3 = m(t2, z3)
    y3 = t0 + t2
    z3 = m(t1, z3)
    t0 = limb.sub_raw(t0, 3 * t2)
    y3 = x3 + m(t0, y3)
    x3 = m(t0, m(x, y))
    return (
        limb.loosen(2 * x3, 2 * limb.LOOSE_MAX),
        limb.loosen(y3, 2 * limb.LOOSE_MAX),
        z3,
    )


def tighten3(p):
    return tuple(limb.tighten(c, limb.LOOSE_MAX) for c in p)


def padd(p, q):
    """Complete addition over (16, *batch) strict planes: the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor."""
    from . import kernels

    return kernels.padd(p, q)


def pdbl(p):
    return tighten3(pdbl_loose(p))


def pneg(p):
    """(x, -y, z): the pneg kernel on a CUDA tensor (``ops.kernels.pneg``),
    its plain version on a CPU tensor."""
    from . import kernels

    return kernels.pneg(p)


def endo(p, interleave: bool = False):
    """GLV endomorphism phi(x, y, z) = (beta x, y, z); with ``interleave``
    the planes of [P_i, phi(P_i)] interleaved along the last axis.  The endo
    kernel on a CUDA tensor (``ops.kernels.endo``), its plain version on a
    CPU tensor."""
    from . import kernels

    return kernels.endo(p, interleave)


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def from_affine_host(points, device):
    """list of affine (x, y) tuples / None -> projective planes on ``device``
    (None becomes the identity (0 : 1 : 0))."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(pt[0] % Q), ys.append(pt[1] % Q), zs.append(1)
    return tuple(limb.from_ints(v, device) for v in (xs, ys, zs))


def normalize3(x, y, z):
    """Canonical (3, 16, *batch) planes, stacked for ONE device-to-host copy:
    the normalize3 kernel on a CUDA tensor (``ops.kernels.normalize3``), its
    plain version on a CPU tensor."""
    from . import kernels

    return kernels.normalize3(x, y, z)


def affine_from_normalized(arr):
    """A fetched (3, 16, K) canonical projective array -> list of affine
    tuples / None (one Python modular inverse per lane)."""
    arr = np.asarray(arr)
    out = []
    for x, y, z in zip(*(limb.unpack_ints(arr[i]) for i in range(3))):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, Q)
            out.append((x * zi % Q, y * zi % Q))
    return out


def to_affine_host(p):
    """Projective (16, K) planes -> list of affine tuples / None: one
    device normalization, one copy, host inverses."""
    return affine_from_normalized(limb.planes_to_numpy(normalize3(*p)))


def to_affine(p):
    """Projective (16, L) strict lanes -> (x, y, inf): x z^-1 and y z^-1
    canonical, inf (L,) bool where z = 0 mod p, x and y 0 there
    (``bulletproofspp_tpu/ops/curve.py:156``).  The to_affine kernel on a
    CUDA tensor (``ops.kernels.to_affine``), its plain version on a CPU
    tensor."""
    from . import kernels

    return kernels.to_affine(*p)


def affine_lanes_to_host(x, y, inf):
    """``to_affine``'s (x, y, inf) -> list of affine tuples / None: one
    device-to-host copy of the three, stacked."""
    arr = limb.planes_to_numpy(torch.cat([x, y, inf.to(limb.DTYPE).unsqueeze(0)]))
    xs, ys = limb.unpack_ints(arr[:limb.NLIMB]), limb.unpack_ints(arr[limb.NLIMB:-1])
    return [None if i else (a, b) for a, b, i in zip(xs, ys, arr[-1])]


def decompress(x, sign):
    """Batched point decompression: x (16, L) canonical coordinates, sign
    (L,) int64 in {0, 1} ("y is the larger root").  Returns (y, ok): y
    canonical with the sign-selected root, ok = x^3 + 7 was a residue.
    The CUDA kernel on a CUDA tensor (``ops.kernels.decompress``), the
    plain version (``ops.kernels.decompress_plain``) on a CPU tensor."""
    from . import kernels

    return kernels.decompress(x, sign)
