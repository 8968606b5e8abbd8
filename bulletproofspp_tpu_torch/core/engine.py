"""Commitment engine abstraction: where EC work actually executes.

The protocol layer (arguments, range proofs) is engine-agnostic; the
engine provides the three hot EC primitives:

  * ``msm(pairs)``            — multi-scalar multiplication (the workhorse;
                                reference: src/Commitment.hs:311-353)
  * ``fold_bases(b,a,ge,go)`` — per-round basis folding b*G_even + a*G_odd
                                with shared ~sqrt(p)-size scalars
                                (reference: src/Commitment.hs:343-353)
  * ``shared_mul(k, pts)``    — k*P_i for a shared scalar (square-completion
                                basis transform, reference:
                                src/Bulletproof/InnerProductArgument.hs:194-206)

``HostEngine`` is the exact-integer ground truth.  ``TorchEngine``
(bulletproofspp_tpu_torch.ops.engine) runs the same math on the card and
must produce identical points.
"""

from __future__ import annotations

from . import ec
from .fields import R


class HostEngine:
    """Pure-Python engine (ground truth / small inputs).

    Base vectors ("BV") are the engine's opaque representation of a basis
    point list; for the host engine that is a plain Python list of affine
    tuples / None.  TorchEngine keeps them as device-resident projective
    limb planes (ops.engine.DevicePoints) so per-round folding never
    round-trips through the host (SURVEY §7.4 host/device choreography).
    """

    # -- point decompression -------------------------------------------------
    def decompress(self, xs, signs):
        """[(x int, sign bool)] -> [affine point | None (not on curve)].
        Host path: one Python pow per point; TorchEngine overrides
        with ONE batched device sqrt over all lanes."""
        from .encoding import from_x_with_sign

        return [from_x_with_sign(x, s) for x, s in zip(xs, signs)]

    # -- base-vector ops -----------------------------------------------------
    def basevec(self, points):
        return list(points)

    def basevec_cached(self, points):
        """Accepts a points list, a single affine point, or an existing
        base vector; host representation is the list itself (no cache
        needed)."""
        if isinstance(points, tuple):
            return [points]
        return points

    def bv_pad(self, bv, m: int):
        return list(bv) + [None] * (m - len(bv))

    def bv_split(self, bv):
        """(even, odd) halves; odd padded to len(even) with the identity
        (the argument layer's pair-padding, reference: src/Bulletproof.hs:63-75)."""
        even = list(bv[0::2])
        odd = list(bv[1::2])
        odd += [None] * (len(even) - len(odd))
        return even, odd

    def msm_groups(self, groups):
        """groups: iterable of (scalars, basevec); returns the combined MSM."""
        pairs = []
        for scalars, bv in groups:
            pairs.extend(zip(scalars, bv))
        return self.msm(pairs)

    def msm_pair(self, groups_a, groups_b):
        return self.msm_groups(groups_a), self.msm_groups(groups_b)

    def msm_many(self, groups_list):
        return [self.msm_groups(g) for g in groups_list]

    def complete_square(self, r: int, g0s, g1s):
        """Square-completion base transform: (g1 + r*g0, g1 - r*g0) lanes
        (reference: src/Bulletproof/InnerProductArgument.hs:194-206)."""
        rp = self.shared_mul(r, g0s)
        gx = [ec.add(g1, p) for g1, p in zip(g1s, rp)]
        hy = [ec.add(g1, ec.neg(p) if p else None) for g1, p in zip(g1s, rp)]
        return gx, hy

    # -- EC primitives --------------------------------------------------------
    def msm(self, pairs):
        flt = [(int(s) % R, p) for s, p in pairs]
        flt = [(s, p) for s, p in flt if s != 0 and p is not None]
        return ec.msm_host([s for s, _ in flt], [p for _, p in flt])

    def fold_bases(self, b: int, a: int, g_even, g_odd):
        return [ec.double_base_mul(b, ge, a, go) for ge, go in zip(g_even, g_odd)]

    # base-vector variant (same math; lists are the host representation)
    fold_bv = fold_bases

    def shared_mul(self, k: int, pts):
        k = int(k) % R
        return [ec.scalar_mul(k, p) if p is not None else None for p in pts]


_default_engine = None


def default_engine():
    """Process-wide engine: the one set by ``set_default_engine``, else a
    ``TorchEngine`` on the CUDA card.  Raises where CUDA is missing: entry
    points run on the card unless the caller asks for the CPU (by setting
    ``TorchEngine("cpu")`` or ``HostEngine()``)."""
    global _default_engine
    if _default_engine is None:
        from ..ops.engine import TorchEngine

        _default_engine = TorchEngine("cuda")
    return _default_engine


def set_default_engine(engine):
    global _default_engine
    _default_engine = engine
