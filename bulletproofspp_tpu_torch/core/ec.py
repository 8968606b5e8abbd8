"""secp256k1 group law — host ground truth.

The reference imports its group law from the external ``elliptic-curve``
package (reference: stack.yaml:44); this module internalizes it.  Points
are affine tuples ``(x, y)`` of ints, or ``None`` for the identity.  A
Jacobian representation ``(X, Y, Z)`` is provided for the host MSM
fallback; the production MSM runs on the card (``bulletproofspp_tpu_torch.ops``).
"""

from __future__ import annotations

from .fields import Q, R

P = Q
B = 7

# Canonical generator (reference: src/Data/Curve/Weierstrass/FastSECP256K1.hs:133-141)
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (GX, GY)

# GLV endomorphism (x,y) -> (beta*x, y) acts as multiplication by lambda.
# beta is the canonical cube root of unity in Fq fixed by the reference
# (reference: src/Data/Curve/Weierstrass/FastSECP256K1.hs:37-60)
BETA = 55594575648329892869085402983802832744385952214688224221778511981742606582254
LAMBDA = 37718080363155996902926221483475020450927657555482586988616620542887997980018

Affine = "tuple[int,int] | None"


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + B)) % P == 0


def neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def add(p1, p2):
    """Complete affine addition (handles identity, doubling, inverse)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def dbl(pt):
    return add(pt, pt)


def endo(pt):
    """GLV endomorphism phi(P) = (beta*x, y) = lambda*P.

    (reference: src/Data/Curve/CM.hs:25-33)
    """
    if pt is None:
        return None
    x, y = pt
    return (BETA * x % P, y)


# ---------------------------------------------------------------------------
# Jacobian arithmetic (X/Z^2, Y/Z^3); identity is Z == 0.
# Formulas match the reference's mixed addition (madd-2007-bl)
# (reference: src/Commitment.hs:130-144) and standard dbl-2007-bl.
# ---------------------------------------------------------------------------

JAC_INF = (1, 1, 0)


def to_jac(pt):
    if pt is None:
        return JAC_INF
    return (pt[0], pt[1], 1)


def from_jac(j):
    x, y, z = j
    if z % P == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 % P * zi % P)


def jac_dbl(j):
    x1, y1, z1 = j
    if z1 % P == 0 or y1 % P == 0:
        return JAC_INF
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = b * b % P
    d = 2 * ((x1 + b) * (x1 + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y1 * z1 % P
    return (x3, y3, z3)


def jac_add(j1, j2):
    """Complete Jacobian addition via case analysis (host-side only)."""
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    if z1 % P == 0:
        return j2
    if z2 % P == 0:
        return j1
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 % P * z2z2 % P
    s2 = y2 * z1 % P * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return JAC_INF
        return jac_dbl(j1)
    h = (u2 - u1) % P
    i = (2 * h) * (2 * h) % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % P * h % P
    return (x3, y3, z3)


def jac_add_affine(j1, a2):
    """Mixed addition J + A (reference: src/Commitment.hs:130-144)."""
    if a2 is None:
        return j1
    x2, y2 = a2
    x1, y1, z1 = j1
    if z1 % P == 0:
        return (x2, y2, 1)
    z1z1 = z1 * z1 % P
    u2 = x2 * z1z1 % P
    s2 = y2 * z1 % P * z1z1 % P
    if u2 == x1 % P:
        if s2 != y1 % P:
            return JAC_INF
        return jac_dbl(j1)
    h = (u2 - x1) % P
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    r = 2 * (s2 - y1) % P
    v = x1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * y1 * j) % P
    z3 = ((z1 + h) * (z1 + h) - z1z1 - hh) % P
    return (x3, y3, z3)


def scalar_mul(k: int, pt):
    """Double-and-add (host fallback)."""
    k %= R
    if k == 0 or pt is None:
        return None
    acc = JAC_INF
    base = to_jac(pt)
    found = False
    for bit in bin(k)[2:]:
        if found:
            acc = jac_dbl(acc)
        if bit == "1":
            if found:
                acc = jac_add(acc, base)
            else:
                acc = base
                found = True
    return from_jac(acc)


def msm_host(scalars, points):
    """Host multi-scalar multiplication: sum_i s_i * P_i (naive windowed).

    Subsumed on device by ops.msm (reference: src/Commitment.hs:311-353).
    Uses 4-bit windows with shared doubling over all points.
    """
    pairs = [(int(s) % R, p) for s, p in zip(scalars, points) if p is not None and int(s) % R != 0]
    if not pairs:
        return None
    w = 4
    nbits = 256
    # precompute small tables per point: [P, 2P, ..., 15P]
    tables = []
    for s, p in pairs:
        tbl = [None] * (1 << w)
        jp = to_jac(p)
        acc = JAC_INF
        for d in range(1, 1 << w):
            acc = jac_add(acc, jp)
            tbl[d] = acc
        tables.append((s, tbl))
    acc = JAC_INF
    for row in range(nbits // w - 1, -1, -1):
        for _ in range(w):
            acc = jac_dbl(acc)
        sh = row * w
        for s, tbl in tables:
            d = (s >> sh) & ((1 << w) - 1)
            if d:
                acc = jac_add(acc, tbl[d])
    return from_jac(acc)


def point_x(x: int):
    """Decompress x to a point using the principal root y = (x^3+7)^((p+1)/4).

    Mirrors ``pointX``/``sr`` used for basis generation (for p = 3 mod 4,
    Tonelli-Shanks reduces to exactly this power).  Returns None if x is
    not on the curve.
    """
    x %= P
    v = (x * x % P * x + B) % P
    y = pow(v, (P + 1) // 4, P)
    if y * y % P != v:
        return None
    return (x, y)


def double_base_mul(a: int, pa, b: int, pb):
    """a*PA + b*PB with signed host scalars (basis folding helper).

    (reference: src/Commitment.hs:343-353 ``projectivePairIP``)
    """
    if a < 0:
        a, pa = -a, neg(pa)
    if b < 0:
        b, pb = -b, neg(pb)
    acc = JAC_INF
    for i in range(max(a.bit_length(), b.bit_length()) - 1, -1, -1):
        acc = jac_dbl(acc)
        if (a >> i) & 1:
            acc = jac_add_affine(acc, pa)
        if (b >> i) & 1:
            acc = jac_add_affine(acc, pb)
    return from_jac(acc)
