"""secp256k1 prime fields Fq (coordinates) and Fr (scalars) — host ground truth.

The reference implements these as hand-rolled 256-bit limb arithmetic
(reference: src/Data/Field/Galois/FastPrime/Internal.hs) plus the generic
``Prime p`` type from the galois-field package.  On the host side we use
Python integers (exact, GMP-backed); ``bulletproofspp_tpu_torch.ops.limb``
and the CUDA kernels (``csrc/field.cuh``) implement the same arithmetic on
16-bit limb planes and are tested against this module.
"""

from __future__ import annotations

# secp256k1 base-field prime (coordinates):  p = 2^256 - 2^32 - 977
Q = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
# secp256k1 group order (scalar field)
R = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

assert Q % 4 == 3  # coordinate field supports sqrt by x^((p+1)/4)


class Fp:
    """Prime-field element.  Subclasses fix the modulus via class attr ``P``.

    Mirrors the numeric tower of the reference's field types
    (reference: src/Data/Field/Galois/FastPrime.hs:100-337).
    """

    __slots__ = ("v",)
    P: int = 0

    def __init__(self, v):
        self.v = (v.v if isinstance(v, Fp) else v) % self.P

    # -- ring ops ----------------------------------------------------------
    def __add__(self, o):
        return type(self)(self.v + _val(o))

    __radd__ = __add__

    def __sub__(self, o):
        return type(self)(self.v - _val(o))

    def __rsub__(self, o):
        return type(self)(_val(o) - self.v)

    def __mul__(self, o):
        return type(self)(self.v * _val(o))

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-self.v)

    def __pow__(self, e: int):
        return type(self)(pow(self.v, e, self.P))

    def inv(self):
        return type(self)(pow(self.v, -1, self.P))

    def __truediv__(self, o):
        ov = _val(o)
        return type(self)(self.v * pow(ov, -1, self.P))

    def __rtruediv__(self, o):
        return type(self)(_val(o) * pow(self.v, -1, self.P))

    # -- comparisons / conversions -----------------------------------------
    def __eq__(self, o):
        if isinstance(o, Fp):
            return type(o) is type(self) and o.v == self.v
        if isinstance(o, int):
            return self.v == o % self.P
        return NotImplemented

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def __int__(self):
        return self.v

    def __repr__(self):
        return f"{type(self).__name__}({self.v})"

    def __bool__(self):
        return self.v != 0

    def sqrt(self):
        """Principal square root for p = 3 mod 4: x^((p+1)/4); None if non-residue.

        Matches galois-field's Tonelli-Shanks which, for s=1, reduces to
        exactly this power (used by ``pointX`` basis generation).
        """
        r = pow(self.v, (self.P + 1) // 4, self.P)
        if r * r % self.P != self.v:
            return None
        return type(self)(r)

    def signed(self) -> int:
        """Signed lift: n if n <= p-n else -(p-n).

        (reference: src/Commitment.hs:276-279 ``reduceScalar``)
        """
        n = self.v
        return -(self.P - n) if n > self.P - n else n


def _val(o) -> int:
    if isinstance(o, Fp):
        return o.v
    if isinstance(o, int):
        return o
    raise TypeError(f"cannot coerce {type(o)} to field element")


class Fq(Fp):
    """Coordinate field GF(Q)."""

    P = Q


class Fr(Fp):
    """Scalar field GF(R)."""

    P = R


def batch_inverse(xs):
    """Montgomery batch inversion; zero maps to zero; order preserved.

    (reference: src/Data/Field/BatchInverse.hs:14-24)
    """
    if not xs:
        return []
    cls = type(xs[0])
    p = cls.P
    n = 1
    stack = []
    for x in xs:
        xv = _val(x)
        if xv % p == 0:
            stack.append((0, n))
        else:
            stack.append((xv, n))
            n = (xv * n) % p
    y = pow(n, -1, p)
    out = [None] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        xv, pref = stack[i]
        if xv == 0:
            out[i] = cls(0)
        else:
            out[i] = cls(y * pref)
            y = (xv * y) % p
    return out
