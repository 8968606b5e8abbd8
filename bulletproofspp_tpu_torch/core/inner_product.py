"""Weighted inner-product argument + norm-via-square-completion wrapper.

The BP+-compatible path: proves s * <x, y>_q with challenge pattern
(1/e, e).  The Norm wrapper maps a norm witness onto a half-length inner
product via completing the square (requires q = -r^2 with -1 a QR class
match), and ``get_witness`` un-completes it so serialization is
argument-agnostic.

(reference: src/Bulletproof/InnerProductArgument.hs)
"""

from __future__ import annotations

from .fields import Fr, R
from .rational import rational_reduce
from . import ec
from .norm_linear import (
    LinearNL,
    _pad_pairs,
    _tensor,
    number_rounds_reduce,
    number_rounds_reduce_strict,
    round_reduce,
    round_reduce_by,
)


def optimal_witness_size_ip(nrm_len: int, lin_len: int):
    """(reference: InnerProductArgument.hs:253-267).  nrm_len counts the
    *norm* witness; the IP vectors have half that length."""
    n_even = (nrm_len + (nrm_len % 2)) // 2
    n_r, n_len = number_rounds_reduce_strict(n_even)
    l_r, l_len = number_rounds_reduce(lin_len)
    r = max(n_r, l_r)
    n_len = round_reduce_by(n_len, r - n_r)
    l_len = round_reduce_by(l_len, r - l_r)
    if 2 * n_len + l_len > 5:
        return r + 1, (2 * round_reduce(n_len), round_reduce(l_len))
    return r, (2 * n_len, l_len)


class NormIP:
    """Norm argument realized as a (completed-square) inner product.

    State is the underlying IP: s (=4), normalizers nx/ny, weight q=r^4,
    element lists xs/gxs/ys/hys (reference: InnerProductArgument.hs:43-124,
    190-231)."""

    def __init__(self, engine, s, nx, ny, q, qinv, xs, gxs, ys, hys):
        self.engine = engine
        self.s = s
        self.nx = nx
        self.ny = ny
        self.q = q
        self.qinv = qinv
        self.xs = xs
        self.gxs = gxs  # base vector
        self.ys = ys
        self.hys = hys  # base vector

    @classmethod
    def make(cls, r: Fr, ss, gs, engine):
        """Square-completion construction (reference: InnerProductArgument.hs:194-206).

        The base transform g' = g1 + r*g0, h' = g1 - r*g0 runs on the
        engine (device-side for TorchEngine, engine.complete_square)."""
        m = max(len(ss), len(gs))
        ss = list(ss) + [Fr(0)] * (m - len(ss))
        gs = list(gs) + [None] * (m - len(gs))
        q = r**4
        half = Fr(2).inv()
        r2inv = (2 * r).inv()
        sp = _pad_pairs(ss, Fr(0))
        g0s = gs[0::2]
        g1s = gs[1::2] + [None] * (len(g0s) - len(gs[1::2]))
        gxs, hys = engine.complete_square(int(r), g0s, g1s)
        xs, ys = [], []
        for s0, s1 in sp:
            xs.append(r2inv * s0 + half * s1)
            ys.append(-(r2inv * s0) + half * s1)
        return cls(engine, Fr(4), Fr(1), Fr(1), q, q.inv(), xs, gxs, ys, hys)

    def _halves(self):
        pad = len(self.xs) % 2
        x_even, x_odd = self.xs[0::2], self.xs[1::2] + [Fr(0)] * pad
        y_even, y_odd = self.ys[0::2], self.ys[1::2] + [Fr(0)] * pad
        gx_even, gx_odd = self.engine.bv_split(self.gxs)
        hy_even, hy_odd = self.engine.bv_split(self.hys)
        return x_even, x_odd, y_even, y_odd, gx_even, gx_odd, hy_even, hy_odd

    def make_scalars_coms(self):
        """(reference: InnerProductArgument.hs:70-81)."""
        q, qinv = self.q, self.qinv
        q2 = q * q
        s = Fr(1)
        sL = Fr(0)
        sR = Fr(0)
        x_even, x_odd, y_even, y_odd, gx_even, gx_odd, hy_even, hy_odd = self._halves()
        for xl, xr, yl, yr in zip(x_even, x_odd, y_even, y_odd):
            sL = sL + s * xl * yr
            sR = sR + s * xr * yl
            s = s * q2
        l_groups = [
            ([qinv * x for x in x_even], gx_odd),
            (list(y_odd), hy_even),
        ]
        r_groups = [
            ([q * x for x in x_odd], gx_even),
            (list(y_even), hy_odd),
        ]
        nxy = self.s * self.nx * self.ny
        return (nxy * q * sL, l_groups, nxy * q2 * sR, r_groups)

    def collapse(self, e: Fr, engine):
        """(reference: InnerProductArgument.hs:86-101)."""
        einv = e.inv()
        a, b = rational_reduce(int(self.qinv * einv), R)
        c, d = rational_reduce(int(e), R)
        b0 = Fr(b)
        d0 = Fr(d)
        b0inv = b0.inv()
        d0inv = d0.inv()
        eq = e * self.q
        x_even, x_odd, y_even, y_odd, gx_even, gx_odd, hy_even, hy_odd = self._halves()
        xs2 = [b0inv * (xl + eq * xr) for xl, xr in zip(x_even, x_odd)]
        ys2 = [d0inv * (yl + einv * yr) for yl, yr in zip(y_even, y_odd)]
        gs2 = engine.fold_bv(b, a, gx_even, gx_odd)
        hs2 = engine.fold_bv(d, c, hy_even, hy_odd)
        return NormIP(
            engine,
            self.s,
            self.nx * b0 * self.qinv,
            self.ny * d0,
            self.q**2,
            self.qinv**2,
            xs2,
            gs2,
            ys2,
            hs2,
        )

    def eval_scalar(self) -> Fr:
        w = self.q
        acc = Fr(0)
        for x, y in zip(self.xs, self.ys):
            acc = acc + w * x * y
            w = w * self.q
        return self.s * self.nx * self.ny * acc

    def get_witness(self):
        """Un-complete the square (reference: InnerProductArgument.hs:222-223)."""
        out = []
        for x, y in zip(self.xs, self.ys):
            nx_x = self.nx * x
            ny_y = self.ny * y
            out.append(nx_x - ny_y)
            out.append(nx_x + ny_y)
        return out


class LinearIP(LinearNL):
    """Linear sub-argument with (1/e, e) pattern
    (reference: InnerProductArgument.hs:149-181)."""

    def make_scalars_coms(self):
        sL = Fr(0)
        sR = Fr(0)
        c_even, c_odd, x_even, x_odd, g_even, g_odd = self._halves()
        for cl, cr, xl, xr in zip(c_even, c_odd, x_even, x_odd):
            sL = sL + cr * xl
            sR = sR + cl * xr
        l_groups = [(list(x_even), g_odd)]
        r_groups = [(list(x_odd), g_even)]
        return sL, l_groups, sR, r_groups

    def collapse(self, e: Fr, engine):
        a, b = rational_reduce(int(e.inv()), R)
        a0 = Fr(a)
        b0 = Fr(b)
        b0inv = b0.inv()
        c_even, c_odd, x_even, x_odd, g_even, g_odd = self._halves()
        cs2 = [b0 * cl + a0 * cr for cl, cr in zip(c_even, c_odd)]
        xs2 = [b0inv * xl + e * b0inv * xr for xl, xr in zip(x_even, x_odd)]
        gs2 = engine.fold_bv(b, a, g_even, g_odd)
        return LinearIP(engine, cs2, xs2, gs2, n=self.n * b0)


class NormLinearIP:
    """Composite argument for the IP path (reference: InnerProductArgument.hs:239-267)."""

    name = "IP"

    def __init__(self, norm: NormIP, lin: LinearIP):
        self.norm = norm
        self.lin = lin

    @classmethod
    def make(cls, q: Fr, cs, nrm_xs, nrm_gs, lin_xs, lin_gs, engine):
        return cls(NormIP.make(q, nrm_xs, nrm_gs, engine), LinearIP(engine, cs, lin_xs, lin_gs))

    @staticmethod
    def optimal_witness_size(nrm_len: int, lin_len: int):
        return optimal_witness_size_ip(nrm_len, lin_len)

    @staticmethod
    def q_powers(q: Fr, k: int):
        """powers' of -q^2 (reference: InnerProductArgument.hs:230-231)."""
        base = -(q * q)
        out = []
        cur = base
        for _ in range(k):
            out.append(cur)
            cur = cur * base
        return out

    @staticmethod
    def make_es(e: Fr):
        return e.inv(), e

    def make_scalars_coms(self):
        sXn, ln, sRn, rn = self.norm.make_scalars_coms()
        sXl, ll, sRl, rl = self.lin.make_scalars_coms()
        return sXn + sXl, ln + ll, sRn + sRl, rn + rl

    def collapse(self, e: Fr, engine):
        return NormLinearIP(self.norm.collapse(e, engine), self.lin.collapse(e, engine))

    def eval_scalar(self) -> Fr:
        return self.norm.eval_scalar() + self.lin.eval_scalar()

    def get_witness(self):
        return self.norm.get_witness() + self.lin.get_witness()


# ---------------------------------------------------------------------------
# verifier-side expansion (reference: InnerProductArgument.hs:103-124,172-181)
# ---------------------------------------------------------------------------


def expand_norm_ip(es, wit_nrm, r: Fr, pub_nrm, nrm_bases, engine=None):
    """Returns (sc, coeff_pairs) where coeff_pairs maps exponents back onto
    the ORIGINAL norm bases (avoiding the verifier-side square-completion
    base transform, which is transcript-invariant).

    es: execution-order challenges; wit_nrm: transmitted norm scalars
    (even count); r: the argument q parameter (q_ip = r^4); pub_nrm: public
    norm constants; nrm_bases: the original basis points.
    """
    n_bases = len(nrm_bases)
    # decode transmitted scalars with the r=1 transform (decode path uses q=1)
    half = Fr(2).inv()
    vs_x = []
    vs_y = []
    for s0, s1 in _pad_pairs(list(wit_nrm), Fr(0)):
        vs_x.append(half * s0 + half * s1)
        vs_y.append(-(half * s0) + half * s1)
    # public constants through the real transform
    r2inv = (2 * r).inv()
    pub = list(pub_nrm) + [Fr(0)] * (n_bases - len(pub_nrm))
    pub_x = []
    pub_y = []
    for p0, p1 in _pad_pairs(pub, Fr(0)):
        pub_x.append(r2inv * p0 + half * p1)
        pub_y.append(-(r2inv * p0) + half * p1)
    n_pairs = len(pub_x)

    q_ip = r**4
    rounds = len(es)
    qs = []
    qf = q_ip
    for _ in range(rounds):
        qs.append(qf)
        qf = qf * qf
    es_x = [e.inv() for e in es]
    sc = Fr(0)
    w = qf
    for x, y in zip(vs_x, vs_y):
        sc = sc + w * x * y
        w = w * qf
    sc = Fr(4) * sc

    ts_x = _tensor(vs_x, es_x, qs, n_pairs)
    ts_y = _tensor(vs_y, es, [Fr(1)] * rounds, n_pairs)

    # exponent cX on g' = g1 + r*g0 and cY on h' = g1 - r*g0
    # recombine: (cX + cY) on g1, r*(cX - cY) on g0
    coeff_pairs = []
    for j in range(n_pairs):
        cx = pub_x[j] - ts_x[j]
        cy = pub_y[j] - ts_y[j]
        g0 = nrm_bases[2 * j]
        g1 = nrm_bases[2 * j + 1] if 2 * j + 1 < n_bases else None
        coeff_pairs.append((r * (cx - cy), g0))
        if g1 is not None:
            coeff_pairs.append((cx + cy, g1))
    return sc, coeff_pairs


def expand_linear_ip(es, vs, pub_cs, pub_xs, n_bases: int):
    """Same as the NL linear expansion but with inverted challenges
    (reference: InnerProductArgument.hs:172-181)."""
    from .norm_linear import expand_linear_nl

    es_inv = [e.inv() for e in es]
    return expand_linear_nl(es_inv, vs, pub_cs, pub_xs, n_bases)
