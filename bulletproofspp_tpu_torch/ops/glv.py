"""Host-side GLV scalar decomposition and signed-digit recoding.

A copy of ``bulletproofspp_tpu.ops.glv`` for the PyTorch port: that
module lives under ``bulletproofspp_tpu.ops``, whose package import
pulls in JAX, so the port keeps its own.  The maths is unchanged:
k = k1 + k2*lambda with |k1|, |k2| ~ sqrt(n), the reduced lattice basis
derived by extended Euclid on (n, lambda) at import time, and the
halves recoded into ROWS = 33 signed base-16 digit rows (|d| <= 8 plus a
sign bit) for the Straus MSM (``bulletproofspp_tpu_torch.ops.msm``).
"""

from __future__ import annotations

import numpy as np

from bulletproofspp_tpu.core.fields import R
from bulletproofspp_tpu.core.ec import LAMBDA

# Digit rows per scalar half: 4-bit signed digits covering |k_i| < 2^131.
ROWS = 33
WBITS = 4


def _derive_lattice():
    """Two short vectors (a, b) with a + b*lambda ≡ 0 (mod n), |a|,|b| ~ sqrt(n).

    Extended Euclid on (n, lambda): r_i = s_i*n + t_i*lambda, so
    (r_i, -t_i) is in the GLV lattice.  Stop at the first remainder below
    sqrt(n) and take that row and the previous one.
    """
    n, lam = R, LAMBDA
    r0, t0 = n, 0
    r1, t1 = lam, 1
    sqrt_n = int(n**0.5) + 1
    while True:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        t0, t1 = t1, t0 - q * t1
        if r1 < sqrt_n:
            break
    v1 = (r1, -t1)
    v2 = (r0, -t0)
    # prefer the shorter second vector between (r0,-t0) and the next row
    q = r0 // r1
    r2, t2 = r0 - q * r1, t0 - q * t1
    if max(abs(r2), abs(t2)) < max(abs(r0), abs(t0)):
        v2 = (r2, -t2)
    # normalize so the lattice determinant is positive (rounding below
    # uses floor-division formulas that assume det > 0)
    if v1[0] * v2[1] - v2[0] * v1[1] < 0:
        v2 = (-v2[0], -v2[1])
    for a, b in (v1, v2):
        assert (a + b * lam) % n == 0
    return v1, v2


_V1, _V2 = _derive_lattice()


def split(k: int) -> tuple[int, int]:
    """k (mod n) -> (k1, k2) with k ≡ k1 + k2*lambda (mod n), |k_i| < 2^130."""
    k %= R
    (a1, b1), (a2, b2) = _V1, _V2
    det = a1 * b2 - a2 * b1  # = ±n (lattice index 1)
    # closest-vector rounding: solve k = c1*v1 + c2*v2 over Q, round
    c1 = (b2 * k * 2 + det) // (2 * det)
    c2 = (-b1 * k * 2 + det) // (2 * det)
    k1 = k - c1 * a1 - c2 * a2
    k2 = -c1 * b1 - c2 * b2
    assert (k1 + k2 * LAMBDA - k) % R == 0
    return k1, k2


def recode_signed(v: int, rows: int = ROWS):
    """Signed int -> (absd, sgn) arrays of signed base-16 digit rows,
    most-significant row first.  absd in [0, 8], sgn in {0, 1};
    v == sum_j (-1)^sgn_j * absd_j * 16^(rows-1-j)."""
    neg = v < 0
    v = -v if neg else v
    absd = np.zeros(rows, np.uint32)
    sgn = np.zeros(rows, np.uint32)
    for j in range(rows):
        d = v & 15
        v >>= WBITS
        if d > 8:
            d -= 16
            v += 1
        absd[rows - 1 - j] = abs(d)
        sgn[rows - 1 - j] = 1 if ((d < 0) != neg) else 0
    if v:
        raise ValueError("scalar too large for digit rows")
    return absd, sgn


def recode_batch(vals, rows: int = ROWS):
    """list[int] -> (absd, sgn) of shape (rows, len(vals))."""
    n = len(vals)
    absd = np.zeros((rows, n), np.uint32)
    sgn = np.zeros((rows, n), np.uint32)
    for i, v in enumerate(vals):
        a, s = recode_signed(v, rows)
        absd[:, i] = a
        sgn[:, i] = s
    return absd, sgn
