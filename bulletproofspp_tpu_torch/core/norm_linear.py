"""Norm-linear argument (the BP++ native argument).

Proves |x|^2_q + <c, l> = v for committed vectors x (norm part, weights
q^{2i+2}) and l (linear part, public coefficients c) in log rounds with
challenge pattern (e, e^2 - 1).

(reference: src/Bulletproof/NormArgument.hs, src/Bulletproof.hs)
"""

from __future__ import annotations

from .fields import Fr, R
from .rational import rational_reduce

# ---------------------------------------------------------------------------
# round-count math (reference: src/Bulletproof.hs:300-316)
# ---------------------------------------------------------------------------


def round_reduce(n: int) -> int:
    """One halving round: ceil(n/2)."""
    q, r = divmod(n, 2)
    return q + r


def round_reduce_by(n: int, k: int) -> int:
    for _ in range(k):
        n = round_reduce(n)
    return n


def number_rounds_reduce(n: int):
    """Reduce until < 5; returns (rounds, final length)."""
    if n < 5:
        return 0, n
    r, n2 = number_rounds_reduce(round_reduce(n))
    return 1 + r, n2


def number_rounds_reduce_strict(n: int):
    """Reduce to <= 2 (reference: src/Bulletproof.hs:306-307)."""
    r, n2 = number_rounds_reduce(n)
    if n2 > 2:
        return r + 1, round_reduce(n2)
    return r, n2


def optimal_witness_size_nl(nrm_len: int, lin_len: int):
    """(rounds, (final_nrm, final_lin)) for the norm-linear argument
    (reference: src/Bulletproof/NormArgument.hs:166-179)."""
    n_r, n_len = number_rounds_reduce(nrm_len)
    l_r, l_len = number_rounds_reduce(lin_len)
    r = max(n_r, l_r)
    n_len = round_reduce_by(n_len, r - n_r)
    l_len = round_reduce_by(l_len, r - l_r)
    if n_len + l_len > 5:
        return r + 1, (round_reduce(n_len), round_reduce(l_len))
    return r, (n_len, l_len)


def _pad_pairs(xs, default):
    """Adjacent pairs, padding a trailing odd element with ``default``."""
    out = []
    for i in range(0, len(xs), 2):
        if i + 1 < len(xs):
            out.append((xs[i], xs[i + 1]))
        else:
            out.append((xs[i], default))
    return out


# ---------------------------------------------------------------------------
# prover state
# ---------------------------------------------------------------------------


class NormNL:
    """Norm sub-argument prover state (reference: NormArgument.hs:86-148).

    Bases are an engine base-vector (device-resident for TorchEngine);
    witness scalars stay host-side Fr."""

    def __init__(self, engine, q: Fr, xs, gs, n: Fr | None = None, qinv: Fr | None = None):
        self.engine = engine
        m = max(len(xs), len(gs))
        self.xs = list(xs) + [Fr(0)] * (m - len(xs))
        self.gs = engine.bv_pad(engine.basevec_cached(gs), m)
        self.q = q
        self.qinv = qinv if qinv is not None else q.inv()
        self.n = n if n is not None else Fr(1)

    def _halves(self):
        x_even = self.xs[0::2]
        x_odd = self.xs[1::2] + [Fr(0)] * (len(self.xs) % 2)
        g_even, g_odd = self.engine.bv_split(self.gs)
        return x_even, x_odd, g_even, g_odd

    def make_scalars_coms(self):
        """Returns (sX, L_groups, sR, R_groups); scalars are Fr, groups are
        (scalar list, base vector) MSM terms (reference: NormArgument.hs:113-117)."""
        q, qinv, n = self.q, self.qinv, self.n
        q4 = q**4
        s = Fr(1)
        sX = Fr(0)
        sR = Fr(0)
        x_even, x_odd, g_even, g_odd = self._halves()
        for xl, xr in zip(x_even, x_odd):
            sX = sX + s * xl * xr
            sR = sR + s * xr * xr
            s = s * q4
        l_groups = [([q * x for x in x_odd], g_even), ([qinv * x for x in x_even], g_odd)]
        r_groups = [(list(x_odd), g_odd)]
        n2 = n * n
        return (2 * n2 * q**3 * sX, l_groups, n2 * q**4 * sR, r_groups)

    def collapse(self, e: Fr, engine):
        """(reference: NormArgument.hs:123-129)."""
        a, b = rational_reduce(int(e * self.qinv), R)
        b0 = Fr(b)
        b0inv = b0.inv()
        eq = e * self.q * b0inv
        x_even, x_odd, g_even, g_odd = self._halves()
        xs2 = [b0inv * xl + eq * xr for xl, xr in zip(x_even, x_odd)]
        gs2 = engine.fold_bv(b, a, g_even, g_odd)
        return NormNL(engine, self.q**2, xs2, gs2, n=self.n * b0 * self.qinv, qinv=self.qinv**2)

    def eval_scalar(self) -> Fr:
        q2 = self.q**2
        w = q2
        acc = Fr(0)
        for x in self.xs:
            acc = acc + w * x * x
            w = w * q2
        return self.n**2 * acc

    def get_witness(self):
        return [self.n * x for x in self.xs]


class LinearNL:
    """Linear sub-argument prover state (reference: NormArgument.hs:34-81)."""

    def __init__(self, engine, cs, xs, gs, n: Fr | None = None):
        self.engine = engine
        m = max(len(cs), len(xs), len(gs))
        self.cs = list(cs) + [Fr(0)] * (m - len(cs))
        self.xs = list(xs) + [Fr(0)] * (m - len(xs))
        self.gs = engine.bv_pad(engine.basevec_cached(gs), m)
        self.n = n if n is not None else Fr(1)

    def _halves(self):
        pad = len(self.xs) % 2
        c_even, c_odd = self.cs[0::2], self.cs[1::2] + [Fr(0)] * pad
        x_even, x_odd = self.xs[0::2], self.xs[1::2] + [Fr(0)] * pad
        g_even, g_odd = self.engine.bv_split(self.gs)
        return c_even, c_odd, x_even, x_odd, g_even, g_odd

    def make_scalars_coms(self):
        """(reference: NormArgument.hs:56-59)."""
        sL = Fr(0)
        sR = Fr(0)
        c_even, c_odd, x_even, x_odd, g_even, g_odd = self._halves()
        for cl, cr, xl, xr in zip(c_even, c_odd, x_even, x_odd):
            sL = sL + cl * xr + cr * xl
            sR = sR + cr * xr
        l_groups = [(list(x_odd), g_even), (list(x_even), g_odd)]
        r_groups = [(list(x_odd), g_odd)]
        return sL, l_groups, sR, r_groups

    def collapse(self, e: Fr, engine):
        a, b = rational_reduce(int(e), R)
        a0 = Fr(a)
        b0 = Fr(b)
        b0inv = b0.inv()
        c_even, c_odd, x_even, x_odd, g_even, g_odd = self._halves()
        cs2 = [b0 * cl + a0 * cr for cl, cr in zip(c_even, c_odd)]
        xs2 = [b0inv * xl + e * b0inv * xr for xl, xr in zip(x_even, x_odd)]
        gs2 = engine.fold_bv(b, a, g_even, g_odd)
        return type(self)(engine, cs2, xs2, gs2, n=self.n * b0)

    def eval_scalar(self) -> Fr:
        acc = Fr(0)
        for c, x in zip(self.cs, self.xs):
            acc = acc + c * x
        return acc

    def get_witness(self):
        return [self.n * x for x in self.xs]


class NormLinearNL:
    """Composite norm+linear argument (reference: NormArgument.hs:153-179,
    Bulletproof.hs:225-273).  Composite scalar s is always 1 in this
    codebase (as in the reference CLI)."""

    name = "NL"

    def __init__(self, norm: NormNL, lin: LinearNL):
        self.norm = norm
        self.lin = lin

    @classmethod
    def make(cls, q: Fr, cs, nrm_xs, nrm_gs, lin_xs, lin_gs, engine):
        return cls(NormNL(engine, q, nrm_xs, nrm_gs), LinearNL(engine, cs, lin_xs, lin_gs))

    @staticmethod
    def optimal_witness_size(nrm_len: int, lin_len: int):
        return optimal_witness_size_nl(nrm_len, lin_len)

    @staticmethod
    def q_powers(q: Fr, k: int):
        """Argument weights: powers of q^2 starting at q^2
        (reference: NormArgument.hs:147-148)."""
        q2 = q * q
        out = []
        cur = q2
        for _ in range(k):
            out.append(cur)
            cur = cur * q2
        return out

    @staticmethod
    def make_es(e: Fr):
        return e, e * e - Fr(1)

    def make_scalars_coms(self):
        sXn, ln, sRn, rn = self.norm.make_scalars_coms()
        sXl, ll, sRl, rl = self.lin.make_scalars_coms()
        return sXn + sXl, ln + ll, sRn + sRl, rn + rl

    def collapse(self, e: Fr, engine):
        return NormLinearNL(self.norm.collapse(e, engine), self.lin.collapse(e, engine))

    def eval_scalar(self) -> Fr:
        return self.norm.eval_scalar() + self.lin.eval_scalar()

    def get_witness(self):
        return self.norm.get_witness() + self.lin.get_witness()


# ---------------------------------------------------------------------------
# verifier-side challenge expansion (reference: NormArgument.hs:73-81,131-145)
# ---------------------------------------------------------------------------


def _tensor(vs, es, qs, length: int):
    """Expanded exponents: T[j*2^R + m] = vs[j] * prod_k (bit k of m ? es[k] : qs[k]).

    es in execution order (round 1 first); qs[k] is the q-power paired with
    round k+1 (reference: Bulletproof.hs:114-123 ``tensor'``).
    """
    rexp = 1 << len(es)
    out = []
    for idx in range(length):
        j, m = divmod(idx, rexp)
        acc = vs[j]
        for k in range(len(es)):
            acc = acc * (es[k] if (m >> k) & 1 else qs[k])
        out.append(acc)
    return out


def expand_norm_nl(es, vs, q: Fr, pub_xs, n_bases: int):
    """Returns (sc, coeffs): final norm value and per-base exponents
    pub - tensor (reference: NormArgument.hs:131-145)."""
    rounds = len(es)
    qf = q
    qs = []
    for _ in range(rounds):
        qs.append(qf)
        qf = qf * qf
    # qf is now q^(2^rounds)
    qf2 = qf * qf
    w = qf2
    sc = Fr(0)
    for v in vs:
        sc = sc + w * v * v
        w = w * qf2
    t = _tensor(vs, es, qs, n_bases)
    pub = list(pub_xs) + [Fr(0)] * (n_bases - len(pub_xs))
    coeffs = [pub[i] - t[i] for i in range(n_bases)]
    return sc, coeffs


def expand_linear_nl(es, vs, pub_cs, pub_xs, n_bases: int):
    """(reference: NormArgument.hs:73-81)."""
    rexp = 1 << len(es)
    exp_es = _tensor([Fr(1)], es, [Fr(1)] * len(es), rexp)
    # the frame pads coefficients to the basis length with zeros
    cs = list(pub_cs) + [Fr(0)] * (n_bases - len(pub_cs))
    # contract': chunk coefficients, dot with the expansion (truncating zip)
    cs_folded = []
    for j in range(0, len(cs), rexp):
        chunk = cs[j : j + rexp]
        acc = Fr(0)
        for a, b in zip(exp_es, chunk):
            acc = acc + a * b
        cs_folded.append(acc)
    sc = Fr(0)
    for cf, v in zip(cs_folded, vs):
        sc = sc + cf * v
    t = _tensor(vs, es, [Fr(1)] * len(es), n_bases)
    pub = list(pub_xs) + [Fr(0)] * (n_bases - len(pub_xs))
    coeffs = [pub[i] - t[i] for i in range(n_bases)]
    return sc, coeffs


def expand_challenges_nl(es, wit_nrm, wit_lin, q: Fr, pub_cs, pub_nrm, pub_lin, n_nrm_bases: int, n_lin_bases: int):
    """Composite expansion: (sc_total, nrm_coeffs, lin_coeffs)."""
    sc_n, coeff_n = expand_norm_nl(es, wit_nrm, q, pub_nrm, n_nrm_bases)
    sc_l, coeff_l = expand_linear_nl(es, wit_lin, pub_cs, pub_lin, n_lin_bases)
    return sc_n + sc_l, coeff_n, coeff_l
