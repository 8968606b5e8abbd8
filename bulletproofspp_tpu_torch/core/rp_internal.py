"""Shared range-proof internals (reference: src/RangeProof/Internal.hs).

``RPW`` is the vector-space witness container (scalar, linear vector,
norm vector); witnesses combine as pub + blind + t*mWit + ... .  The
blinding functions implement the single-round blinding protocol with the
diagonal-sum error-term cancellation table.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .fields import Fr
from .utils import insert_at, pad_right, remove_at


@dataclass
class RPW:
    """(reference: Internal.hs:22-41)."""

    sc: Fr
    lin: list
    nrm: list

    @staticmethod
    def zero():
        return RPW(Fr(0), [], [])

    def __add__(self, other: "RPW") -> "RPW":
        n_l = max(len(self.lin), len(other.lin))
        n_n = max(len(self.nrm), len(other.nrm))
        lin = [
            (self.lin[i] if i < len(self.lin) else Fr(0))
            + (other.lin[i] if i < len(other.lin) else Fr(0))
            for i in range(n_l)
        ]
        nrm = [
            (self.nrm[i] if i < len(self.nrm) else Fr(0))
            + (other.nrm[i] if i < len(other.nrm) else Fr(0))
            for i in range(n_n)
        ]
        return RPW(self.sc + other.sc, lin, nrm)

    def scale(self, s: Fr) -> "RPW":
        return RPW(s * self.sc, [s * x for x in self.lin], [s * x for x in self.nrm])


def _rpw_groups(engine, w: RPW, g, hs, gs):
    return [
        ([w.sc], engine.basevec_cached(g)),
        (w.lin, engine.basevec_cached(hs)),
        (w.nrm, engine.basevec_cached(gs)),
    ]


def commit_rpw(engine, w: RPW, g, hs, gs):
    """sc*g + <lin, hs> + <nrm, gs> (reference: Internal.hs:43-48).

    Routed through the grouped MSM API so TorchEngine reuses its cached
    device-resident copies of the (fixed per-setup) basis vectors."""
    return engine.msm_groups(_rpw_groups(engine, w, g, hs, gs))


def commit_rpw_many(engine, ws, g, hs, gs):
    """K phase commitments in one engine dispatch (they all precede a
    single oracle challenge, so fusing them costs nothing semantically
    and saves K-1 blocking device round-trips)."""
    return engine.msm_many([_rpw_groups(engine, w, g, hs, gs) for w in ws])


def make_poly_terms(ws, tss):
    """Weighted self-convolution: out[m] = sum_{i+j=m} <v_i, v_j>_w
    (reference: Internal.hs:65-76)."""
    k = len(tss)
    out = [Fr(0)] * (2 * k - 1)

    def wdot(a, b):
        acc = Fr(0)
        for w, x, y in zip(ws, a, b):
            acc = acc + w * x * y
        return acc

    for i in range(k):
        for j in range(k):
            out[i + j] = out[i + j] + wdot(tss[i], tss[j])
    return out


def counts(xs, ys):
    """Multiplicity of each x in ys (reference: Internal.hs:79-81)."""
    m = {}
    for y in ys:
        m[y] = m.get(y, 0) + 1
    return [m.get(x, 0) for x in xs]


def sums_rows(rows):
    """Elementwise sum of equal-length rows (reference: src/Utils.hs:227-228)."""
    out = list(rows[0])
    for r in rows[1:]:
        for i, x in enumerate(r):
            out[i] = out[i] + x
    return out


def sum_diagonals(xss):
    """Anti-diagonal sums of a ragged table (reference: Internal.hs:107-113)."""
    m = {}
    for a, xs in enumerate(xss):
        for b, x in enumerate(xs):
            m[a + b] = m.get(a + b, Fr(0)) + x
    return [m[k] for k in sorted(m)]


def scale_errs(n: int, r, xs):
    """Scale entries [n+1, 2n-2) by r (reference: Internal.hs:119-122)."""
    ys, zs = xs[: n + 1], xs[n + 1 :]
    a, bs = zs[: n - 2], zs[n - 2 :]
    return ys + [r * x for x in a] + bs


def blind_witness(tr, n: int, k: int, ls, ns) -> RPW:
    """Witness commitment blinding for a value entering at t^k
    (reference: Internal.hs:134-142)."""
    n_bls = 2 * n - 1 if k == 1 else 2 * n - k + 1
    bls = [Fr(v) for v in tr.randoms(n_bls)]
    bls = pad_right(2 * n + 1, Fr(0), insert_at(2 * n - k, Fr(0), bls))
    return RPW(bls[0], bls[1:] + list(ls), list(ns))


def blind_err_witness(tr, n: int, es, ls, ns) -> RPW:
    """Witness commitment with embedded error terms
    (reference: Internal.hs:145-152)."""
    n_bls = n + 1
    bls = [Fr(v) for v in tr.randoms(n_bls)]
    bls = pad_right(2 * n + 1, Fr(0), insert_at(n, Fr(0), bls) + list(es))
    return RPW(bls[0], bls[1:] + list(ls), list(ns))


def blind_blinding_term(bl_bls: RPW, t_c: Fr, r0_pair, r1_pair, errs, wits, input_bl: Fr) -> RPW:
    """Final blinding commitment: cancels all cross error terms via the
    diagonal-sum table (reference: Internal.hs:157-195)."""
    r0, r0inv = r0_pair
    r1, r1inv = r1_pair
    assert int(bl_bls.sc) == 0
    bl_t, bls_lin = bl_bls.lin[0], bl_bls.lin[1:]
    bls_nrm = bl_bls.nrm
    rs_inv = r0inv * r1inv
    n = len(wits)

    wits_front, wit_err = wits[: n - 1], wits[n - 1]
    wit_err_row = [wit_err.sc] + pad_right(2 * n, Fr(0), wit_err.lin[: n + 1])
    # zipWith truncates: scalars of the first n-1 wits pair with their own linears
    wit_rows = [[w.sc] + wf.lin[: 2 * n] for w, wf in zip(wits, wits_front)]
    wit_rows = wit_rows + [wit_err_row]

    def neg_tail(row):
        return row[:2] + [-x for x in row[2:]]

    wit_rows = [neg_tail(r) for r in wit_rows]

    errs2 = [-(errs[0] - t_c * bl_t)] + [-(rs_inv * e) for e in errs[1:]]

    def add_consts(a, b, row):
        return [a * row[0] + b * row[1]] + row[2:]

    table_rows = [errs2] + [
        scale_errs(n, r1inv, add_consts(rs_inv, rs_inv * t_c, r)) for r in wit_rows
    ]
    table = [insert_at(2 * n - 1, Fr(0), r) for r in table_rows]
    diag = sum_diagonals(table)
    bl_errs = scale_errs(n, r1, remove_at(2 * n - 1, diag)[: 2 * n])
    # appLast: remove the input blinding from the final error term
    bl_errs = bl_errs[:-1] + [bl_errs[-1] - 2 * input_bl]
    return RPW(-bl_errs[0], [bl_t] + bl_errs[1:] + bls_lin, bls_nrm)
