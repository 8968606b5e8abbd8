"""Typed-reciprocal range proof — the BP++ flagship protocol.

(reference: src/RangeProof/TypedReciprocal.hs)

Base-b digits are proven via the log-derivative permutation argument
  sum_i 1/(e + d_i) = sum_j m_j/(e + j),
typed conservation via sum (-1)^o v/(e + t) = 0.  Four phases:
  1. commit digits+shared multiplicities (DM) and inline multiplicities (M)
  2. challenge e -> commit reciprocals (R), with one batched inversion
  3. challenges (q, x', r1) -> commit blinding (B) with the 7-term error
     polynomial cancellation
  4. challenge t -> assemble the bulletproof witness
     pub + B + t*M + t^2*DM + t^3*R + 2t^5*sum(inputCoeffs_i * N_i).
"""

from __future__ import annotations

from dataclasses import dataclass

from .fields import Fr, batch_inverse
from .utils import (
    de_dup,
    drop_if,
    integer_log,
    pad_right,
    replace_if,
    split_at_maybe,
    take_maybe,
)
from .rp_internal import (
    RPW,
    blind_blinding_term,
    blind_err_witness,
    blind_witness,
    commit_rpw,
    counts,
    sums_rows,
)
from .bulletproof import BPSetup, prove_bp


# ---------------------------------------------------------------------------
# range data (reference: TypedReciprocal.hs:79-126)
# ---------------------------------------------------------------------------


@dataclass
class RangeDataT:
    base: int
    min: int
    max: int
    is_shared: bool
    is_output: bool
    is_assumed: bool
    has_bit: bool
    base_coeffs: list


def make_range_data(char: int, b: int, rmin: int, rmax: int, is_s: bool, is_o: bool, is_a: bool):
    if not (rmax > rmin and b > 1 and rmax - rmin < char):
        return None
    width = rmax - rmin
    n1 = integer_log(b, width - 1)
    has_bit = (width - 1) % (b - 1) != 0
    if not has_bit:
        bs = [(width - b**n1) // (b - 1)] + [b ** (n1 - i) for i in range(1, n1 + 1)]
    elif width < 2 * b**n1:
        bs = [width - b**n1] + [b ** (n1 - i) for i in range(1, n1 + 1)]
    else:
        bn1 = 1 + width // (2 * (b - 1)) - (b**n1 - 1) // (b - 1)
        bs = [width - bn1 * (b - 1) - b**n1, bn1] + [b ** (n1 - i) for i in range(1, n1 + 1)]
    return RangeDataT(b, rmin, rmax, is_s, is_o, is_a, has_bit, [] if is_a else bs)


def digits_of(rd: RangeDataT, n: int) -> list:
    """Greedy digit decomposition min(base-1, n // coeff)
    (reference: TypedReciprocal.hs:124-126).  If has_bit, the first digit
    is binary."""
    bases = [2] * rd.has_bit + [rd.base] * len(rd.base_coeffs)
    out = []
    for coeff, base in zip(rd.base_coeffs, bases):
        d = min(base - 1, n // coeff)
        out.append(d)
        n -= d * coeff
    return out


# ---------------------------------------------------------------------------
# phase-1 rows (reference: TypedReciprocal.hs:53-159)
# ---------------------------------------------------------------------------


@dataclass
class Ph1:
    """One row of the witness table.  kind in {"typing", "inline", "shared"}.
    Private fields (d, m, v_amt, t_type) are None on the verifier side."""

    kind: str
    ind: int
    base: int = 0
    b: Fr = None  # digit coefficient (public)
    d: object = None  # digit value (private)
    m: object = None  # multiplicity (private)
    s: Fr = None  # symbol (public)
    is_output: bool = False
    is_assumed: bool = False
    v_amt: object = None  # amount (private, typing rows)
    t_type: object = None  # type (private, typing rows)


def make_phase1s(ind: int, rd: RangeDataT, v):
    """Prover-side phase-1 rows for one range; returns (rows, ms or None)
    or None if out of range (reference: TypedReciprocal.hs:132-153)."""
    if rd.is_assumed:
        return [], None
    n_adj = int(Fr(v) - Fr(rd.min))
    if not (0 <= n_adj < rd.max - rd.min):
        return None
    ds = digits_of(rd, n_adj)
    if rd.has_bit:
        ms = [ds[0]] + counts(list(range(1, rd.base)), ds[1:])
        ns = [1] + list(range(1, rd.base))
    else:
        ms = counts(list(range(1, rd.base)), ds)
        ns = list(range(1, rd.base))
    bs = rd.base_coeffs
    bases = [2] * rd.has_bit + [rd.base] * max(len(bs), len(ds), len(ms), len(ns))
    if rd.is_shared:
        rows = [
            Ph1("shared", ind, base=base, b=Fr(b), d=Fr(d))
            for base, b, d in zip(bases, bs, ds)
        ]
        return rows, [Fr(m) for m in ms]
    n = max(len(bs), len(ds), len(ms), len(ns))
    bs_p, ds_p, ms_p, ns_p = (pad_right(n, 0, list(xs)) for xs in (bs, ds, ms, ns))
    rows = [
        Ph1("inline", ind, base=base, b=Fr(b), d=Fr(d), m=Fr(m), s=Fr(sym))
        for base, b, d, m, sym in zip(bases, bs_p, ds_p, ms_p, ns_p)
    ]
    return rows, None


def make_phase1s_ver(ind: int, rd: RangeDataT):
    """Verifier-side rows: same shape, private fields empty
    (reference: TypedReciprocal.hs:157-159)."""
    if rd.is_assumed:
        return []
    bs = rd.base_coeffs
    if rd.has_bit:
        ns = [1] + list(range(1, rd.base))
    else:
        ns = list(range(1, rd.base))
    bases = [2] * rd.has_bit + [rd.base] * max(len(bs), len(ns))
    if rd.is_shared:
        return [Ph1("shared", ind, base=base, b=Fr(b)) for base, b in zip(bases, bs)]
    # verifier digit/mult vectors have lengths len(bs) and len(ns)
    n = max(len(bs), len(ns))
    bs_p = pad_right(n, 0, list(bs))
    ns_p = pad_right(n, 0, list(ns))
    return [
        Ph1("inline", ind, base=base, b=Fr(b), s=Fr(sym))
        for base, b, sym in zip(bases, bs_p, ns_p)
    ]


def base_mss(mss_maybe, bases, bits):
    """Aggregate shared multiplicities per base, bit digits under base 2;
    ascending base order (reference: TypedReciprocal.hs:366-371)."""
    acc: dict = {}
    for bit, base, ms in zip(bits, bases, mss_maybe):
        if ms is None:
            continue
        entries = [(2, [ms[0]]), (base, ms[1:])] if bit else [(base, ms)]
        for b, v in entries:
            if b in acc:
                # zipWith (+) truncates to the shorter list
                acc[b] = [a + c for a, c in zip(acc[b], v)]
            else:
                acc[b] = list(v)
    return sorted(acc.items())


# ---------------------------------------------------------------------------
# phase 2 (reference: TypedReciprocal.hs:169-206)
# ---------------------------------------------------------------------------


@dataclass
class Ph2:
    is_t: bool
    d: object  # private
    m: object  # private
    u: Fr  # public
    v: Fr  # public
    r: object  # private reciprocal
    c: Fr  # public reciprocal coefficient


def make_phase2s(prover: bool, has_types: bool, e: Fr, e_inv: Fr, x: Fr, base_map, ph1s):
    """(reference: TypedReciprocal.hs:174-196).  For the verifier the
    private columns stay None (the reference uses the Num () instance)."""
    ds, ss, ps, vs, mk = [], [], [], [], []
    for ph1 in ph1s:
        xp = x ** (2 * (ph1.ind + 1))
        if ph1.kind == "typing":
            xq = -x if ph1.is_output else x
            ds.append((e + ph1.t_type) if prover else None)
            ss.append(Fr(0))
            ps.append(ph1.v_amt if prover else None)
            vs.append(xq)
            mk.append((True, ph1.t_type, Fr(0) if prover else None, Fr(0) if ph1.is_assumed else xp, xq))
        else:
            xq = base_map[ph1.base]
            ds.append((e + ph1.d) if prover else None)
            if ph1.kind == "inline" and int(ph1.s) != 0:
                ss.append(e + ph1.s)
            else:
                ss.append(Fr(0))
            ps.append(Fr(1) if prover else None)
            vs.append(xq)
            m = (ph1.m if ph1.kind == "inline" else Fr(0)) if prover else None
            mk.append((False, ph1.d, m, xp * ph1.b, xq))
    if prover:
        rs = [p * di for p, di in zip(ps, batch_inverse(ds))]
    else:
        rs = [None] * len(ph1s)
    s_invs = batch_inverse(ss)
    cs = [v * ((e_inv - si) if int(si) != 0 else Fr(0)) for v, si in zip(vs, s_invs)]
    return [
        Ph2(is_t, d, m, u, v, r, c)
        for (is_t, d, m, u, v), r, c in zip(mk, rs, cs)
    ]


def err7_term(ph2s) -> Fr:
    """(reference: TypedReciprocal.hs:199-201)."""
    acc = Fr(0)
    for p in ph2s:
        acc = acc + 2 * p.r * p.c
    return acc


def make_shared_coeffs(e: Fr, e_inv: Fr, m_bases, base_map):
    """Public coefficients for shared-multiplicity linear slots
    (reference: TypedReciprocal.hs:204-206)."""
    xs, ss = [], []
    for b in m_bases:
        for s in range(1, b):
            xs.append(base_map[b])
            ss.append(e + Fr(s))
    return [xv * (e_inv - si) for xv, si in zip(xs, batch_inverse(ss))]


# ---------------------------------------------------------------------------
# phase 3 (reference: TypedReciprocal.hs:213-258)
# ---------------------------------------------------------------------------


def make_error_terms(e: Fr, xp: Fr, shared_cs, bls_ms, ph2s, q_pows, bls_nrm):
    """Six error-term sums [err0..err4, err6]
    (reference: TypedReciprocal.hs:217-232)."""
    aug = Fr(0)
    for c, b in zip(shared_cs, bls_ms):
        aug = aug + c * b
    rows = [[Fr(0), Fr(0), Fr(0), 2 * aug, Fr(0), Fr(0)]]
    for p, q2, bl in zip(ph2s, q_pows, bls_nrm):
        r_c = xp * (p.u + q2) if p.is_t else p.u
        d_c = p.v + q2 * e
        qd = q2 * p.d + d_c
        qr = q2 * p.r + r_c
        rows.append(
            [
                q2 * bl * bl,
                2 * q2 * p.m * bl,
                q2 * p.m * p.m + 2 * bl * qd,
                2 * (bl * qr + p.m * qd),
                (q2 * p.d * p.d + 2 * p.d * d_c) + 2 * (bl * p.c + p.m * qr),
                (q2 * p.r * p.r + 2 * p.r * r_c) + 2 * p.c * p.d,
            ]
        )
    return sums_rows(rows)


def make_public_consts(
    e: Fr, e_inv: Fr, x: Fr, xp: Fr, q0: Fr, q0inv: Fr, t: Fr, has_types: bool, rds, pub_vt, ph2s
):
    """(reference: TypedReciprocal.hs:235-258)."""
    is_as = [rd.is_assumed for rd in rds]
    mins = replace_if(is_as, Fr(0), [Fr(rd.min) for rd in rds])
    x2 = x * x
    acc = Fr(0)
    p = x2
    for m in mins:
        acc = acc + m * p
        p = p * x2
    t5 = t**5
    z = Fr(-2) * t5 * acc
    if has_types:
        pub_rs = batch_inverse([e + Fr(tt) for (_, tt, _) in pub_vt])
        pub_sum = Fr(0)
        for (is_out, _, v), r in zip(pub_vt, pub_rs):
            term = r * Fr(v)
            pub_sum = pub_sum + (-term if is_out else term)
        z = z - 2 * t5 * x * pub_sum
    ts0 = Fr(0)
    ts1 = []
    q2, q2inv = q0, q0inv
    for p2 in ph2s:
        if p2.is_t:
            r_c = xp * (q2inv * p2.u + Fr(1))
            p2c = Fr(0)
        else:
            r_c = q2inv * p2.u
            p2c = 2 * q2 + 2 * e_inv * p2.v
        pv = t**2 * (e + q2inv * p2.v) + t**3 * r_c + t**4 * (q2inv * p2.c)
        ts0 = ts0 + q2 * pv * pv + t5 * p2c
        ts1.append(pv)
        q2 = q2 * q0
        q2inv = q2inv * q0inv
    return RPW(z + ts0, [], ts1)


def input_coeffs_t(has_types: bool, assumed, x: Fr, q0: Fr):
    """(reference: TypedReciprocal.hs:325-328)."""
    out = []
    x2 = x * x
    xp = x2
    qp = q0
    for a in assumed:
        c = Fr(0) if a else xp
        if has_types:
            c = c + qp
        out.append(c)
        xp = xp * x2
        qp = qp * q0
    return out


def make_bp_coeffs(has_types: bool, xp: Fr, r0: Fr, r1: Fr, t: Fr, cs):
    """(reference: TypedReciprocal.hs:391-396)."""
    rs = r0 * r1
    ct = -xp if has_types else Fr(0)
    return [ct, rs * t, rs * t**2, rs * t**3, r0 * t**4, rs * t**6] + [
        2 * t**3 * c for c in cs
    ]


# ---------------------------------------------------------------------------
# setup / witness / prover / verifier (reference: TypedReciprocal.hs:309-467)
# ---------------------------------------------------------------------------

NUM_TERMS = 3  # commitment count before blinding (M, DM, R)


def _nrm_rows(rd: RangeDataT) -> int:
    """Number of committed phase-1 rows for one range (typing row
    excluded): assumed ranges commit nothing, shared ranges commit one
    row per digit (multiplicities live in the shared linear slots), and
    inline ranges commit max(digits, symbols) rows — the exact length
    make_phase1s pads its row table to."""
    if rd.is_assumed:
        return 0
    if rd.is_shared:
        return len(rd.base_coeffs)
    n_sym = rd.base if rd.has_bit else rd.base - 1
    return max(len(rd.base_coeffs), n_sym)


@dataclass
class SetupTRRP:
    arg_cls: type
    has_types: bool
    m_bases: list  # sorted distinct shared bases (incl. 2 for shared bits)
    sorted_bases: list  # all distinct bases for the x-power map
    nrm_len: int
    lin_len: int
    pub_vt: list  # [(is_output, type, value)]
    rds: list
    h: object
    g: object
    hs: list
    gs: list

    @classmethod
    def make(cls, arg_cls, points, has_types: bool, pub_vt, rds):
        """(reference: TypedReciprocal.hs:332-359)."""
        if len(points) < 2:
            return None
        h, g, rest = points[0], points[1], points[2:]
        is_as = [rd.is_assumed for rd in rds]
        live = drop_if(is_as, rds)
        any_has_bit = any(rd.has_bit for rd in live)
        any_shared_has_bit = any(rd.has_bit and rd.is_shared for rd in live)
        shared_bases = [rd.base for rd in live if rd.is_shared]
        m_bases = de_dup(([2] if any_shared_has_bit else []) + shared_bases)
        sorted_bases = de_dup(([2] if any_has_bit else []) + [rd.base for rd in live])
        # One norm term per COMMITTED phase-1 row.  The reference sizes this
        # as one term per digit (reference: TypedReciprocal.hs:344 "nrmLen =
        # sum ... length . baseCoeffs"), but its own inline phase-1 rows pad
        # to max(digits, #symbols) = max(len bs, base-1 [+bit])
        # (reference: TypedReciprocal.hs:150-152 "padRight (maximum $
        # length <$> wits)"): for any non-shared range with fewer digits
        # than symbols the symbol-multiplicity rows would overrun the basis
        # and Haskell's zipWith would silently truncate them out of the
        # commitment, breaking the reciprocal conservation argument (proofs
        # never verify).  Every reference example satisfies digits >=
        # base-1, masking this.  We size the basis to the true row count —
        # identical to the reference wherever the reference works, and
        # completing the schema class (e.g. base 16 below 60-bit widths) it
        # silently cannot serve.  Pinned by tests/test_small_widths.py.
        nrm_len = sum(_nrm_rows(rd) + (1 if has_types else 0) for rd in rds)
        lin_len = 6 + sum(b - 1 for b in m_bases)
        sp = split_at_maybe(lin_len, rest)
        if sp is None:
            return None
        hs, rest2 = sp
        gs = take_maybe(nrm_len, rest2)
        if gs is None:
            return None
        return cls(
            arg_cls, has_types, m_bases, sorted_bases, nrm_len, lin_len, pub_vt, rds, h, g, hs, gs
        )

    def base_map(self, x: Fr):
        """{base: x^(2i+3)} over sorted distinct bases
        (reference: TypedReciprocal.hs:353)."""
        out = {}
        p = x**3
        x2 = x * x
        for b in self.sorted_bases:
            out[b] = p
            p = p * x2
        return out

    def commit(self, engine, w: RPW):
        return commit_rpw(engine, w, self.g, self.hs, self.gs)

    def commit_many(self, engine, ws):
        from .rp_internal import commit_rpw_many

        return commit_rpw_many(engine, ws, self.g, self.hs, self.gs)

    def info(self):
        return 4, self.nrm_len, self.lin_len

    def n_input_coms(self):
        return len(self.rds)

    # -- witness (reference: TypedReciprocal.hs:373-388) ---------------------
    def witness(self, values):
        """values: [((amount, type), blind)] as integers/Fr."""
        vs = [Fr(v) for (v, _), _ in values]
        ts = [Fr(tt) for (_, tt), _ in values]
        if self.has_types:
            type_sums: dict = {}
            for io, tt, v in self.pub_vt:
                k = int(Fr(tt))
                type_sums[k] = type_sums.get(k, Fr(0)) + (-Fr(v) if io else Fr(v))
            for tt, v, rd in zip(ts, vs, self.rds):
                k = int(tt)
                type_sums[k] = type_sums.get(k, Fr(0)) + (-v if rd.is_output else v)
            if any(int(s) != 0 for s in type_sums.values()):
                return None
        ph1ss = []
        mss = []
        for i, (rd, v) in enumerate(zip(self.rds, vs)):
            res = make_phase1s(i, rd, v)
            if res is None:
                return None
            rows, ms = res
            ph1ss.append(rows)
            mss.append(ms)
        types = [
            Ph1("typing", i, is_output=rd.is_output, is_assumed=rd.is_assumed, v_amt=v, t_type=tt)
            for i, (rd, v, tt) in enumerate(zip(self.rds, vs, ts))
        ]
        ph1s = (types if self.has_types else []) + [r for rows in ph1ss for r in rows]
        bmss = base_mss(mss, [rd.base for rd in self.rds], [rd.has_bit for rd in self.rds])
        return ph1s, bmss

    # -- BP setup assembly ----------------------------------------------------
    def _bp_setup(self, q: Fr, x: Fr, q0: Fr, t: Fr, bp_coeffs, pub: RPW, coms) -> BPSetup:
        rounds = self.arg_cls.optimal_witness_size(self.nrm_len, self.lin_len)[0]
        bl_com, r_com, dm_com, m_com = coms[0], coms[1], coms[2], coms[3]
        n_coms = coms[4:]
        is_as = [rd.is_assumed for rd in self.rds]
        ics = input_coeffs_t(self.has_types, is_as, x, q0)
        t5 = t**5
        init_pairs = [(Fr(1), bl_com), (t, m_com), (t * t, dm_com), (t**3, r_com)] + [
            (2 * t5 * c, nc) for c, nc in zip(ics, n_coms)
        ]
        return BPSetup(
            arg_cls=self.arg_cls,
            scalar_base=self.g,
            q=q,
            bp_coeffs=bp_coeffs,
            pub_scalar=pub.sc,
            pub_nrm=pub.nrm,
            pub_lin=pub.lin,
            nrm_bases=self.gs,
            lin_bases=self.hs,
            rounds=rounds,
            init_pairs=init_pairs,
        )

    # -- prover (reference: TypedReciprocal.hs:399-444) -----------------------
    def prove(self, tr, engine, values, wit):
        ph1s, bmss = wit
        arg = self.arg_cls
        m_bases_w = [b for b, _ in bmss]
        ms_shared = [m for _, ms in bmss for m in ms]
        ds = []
        ms_inline = []
        for p in ph1s:
            if p.kind == "inline":
                ds.append(p.d)
                ms_inline.append(p.m)
            elif p.kind == "shared":
                ds.append(p.d)
                ms_inline.append(Fr(0))
            else:
                ds.append(p.t_type)
                ms_inline.append(Fr(0))

        n_wits = [RPW(Fr(v), [Fr(tt), Fr(bl)], []) for (v, tt), bl in values]
        dm_wit = blind_witness(tr, NUM_TERMS, 2, ms_shared, ds)
        m_wit = blind_witness(tr, NUM_TERMS, 1, [], ms_inline)
        # all Phase-1 commitments precede ONE oracle call: fuse dispatches
        coms = self.commit_many(engine, n_wits + [dm_wit, m_wit])
        n_coms, dm_com, m_com = coms[:-2], coms[-2], coms[-1]

        e, x, r0 = (Fr(v) for v in tr.oracle([dm_com, m_com] + n_coms, 3))
        e_inv, r0_inv = batch_inverse([e, r0])

        base_map = self.base_map(x)
        ph2s = make_phase2s(True, self.has_types, e, e_inv, x, base_map, ph1s)
        err7 = r0_inv * (-err7_term(ph2s))
        r_wit = blind_err_witness(tr, NUM_TERMS, [err7], [], [p.r for p in ph2s])
        r_com = self.commit(engine, r_wit)

        q, xp, r1 = (Fr(v) for v in tr.oracle([r_com], 3))
        q_pows = arg.q_powers(q, self.nrm_len)
        q0 = q_pows[0]
        q0_inv, r1_inv = batch_inverse([q0, r1])
        shared_cs = make_shared_coeffs(e, e_inv, m_bases_w, base_map)
        t_c = xp if self.has_types else Fr(0)

        bls_lin = [Fr(v) for v in tr.randoms(self.lin_len - 5)]
        bls_nrm = [Fr(v) for v in tr.randoms(self.nrm_len)]
        bl_bls = RPW(Fr(0), bls_lin, bls_nrm)
        bls_ms = bls_lin[1:]

        is_as = [rd.is_assumed for rd in self.rds]
        ics = input_coeffs_t(self.has_types, is_as, x, q0)
        n_wit_sum = RPW.zero()
        for c, w in zip(ics, n_wits):
            n_wit_sum = n_wit_sum + w.scale(c)
        input_bl = n_wit_sum.lin[1]
        errs = make_error_terms(e, xp, shared_cs, bls_ms, ph2s, q_pows, bls_nrm)
        bl_wit = blind_blinding_term(
            bl_bls, t_c, (r0, r0_inv), (r1, r1_inv), errs, [m_wit, dm_wit, r_wit], input_bl
        )
        bl_com = self.commit(engine, bl_wit)
        t = Fr(tr.oracle([bl_com], 1)[0])

        pub = make_public_consts(
            e, e_inv, x, xp, q0, q0_inv, t, self.has_types, self.rds, self.pub_vt, ph2s
        )
        bp_wit = (
            pub
            + bl_wit
            + m_wit.scale(t)
            + dm_wit.scale(t * t)
            + r_wit.scale(t**3)
            + n_wit_sum.scale(2 * t**5)
        )
        coms = [bl_com, r_com, dm_com, m_com] + n_coms
        bp_coeffs = make_bp_coeffs(self.has_types, xp, r0, r1, t, shared_cs)
        bp_setup = self._bp_setup(q, x, q0, t, bp_coeffs, pub, coms)
        proof = prove_bp(tr, engine, bp_setup, bp_wit.sc, bp_wit.nrm, bp_wit.lin)
        return coms, bp_setup, proof

    # -- verifier (reference: TypedReciprocal.hs:447-467) ---------------------
    def setup_from_challenges(self, coms, e, x, r0, q, xp, r1, t) -> tuple:
        """Verifier-side BPSetup assembly given the challenges.

        Shared by ``verify_setup`` (which derives the challenges from the
        transcript replay) and the multiparty dealer (core/mp_prove.py,
        which already holds them from its live oracle rounds).  Returns
        ``(bp_setup, pub)`` — the dealer needs ``pub`` to complete the
        aggregate witness; plain verification ignores it."""
        if len(coms) != 4 + len(self.rds):
            raise ValueError("wrong commitment count")
        ph1s = [
            Ph1("typing", i, is_output=rd.is_output, is_assumed=rd.is_assumed)
            for i, rd in enumerate(self.rds)
        ] if self.has_types else []
        for i, rd in enumerate(self.rds):
            ph1s += make_phase1s_ver(i, rd)
        q0 = self.arg_cls.q_powers(q, 1)[0]
        e_inv, q0_inv = batch_inverse([e, q0])
        base_map = self.base_map(x)
        ph2s = make_phase2s(False, self.has_types, e, e_inv, x, base_map, ph1s)
        pub = make_public_consts(
            e, e_inv, x, xp, q0, q0_inv, t, self.has_types, self.rds, self.pub_vt, ph2s
        )
        shared_cs = make_shared_coeffs(e, e_inv, self.m_bases, base_map)
        bp_coeffs = make_bp_coeffs(self.has_types, xp, r0, r1, t, shared_cs)
        return self._bp_setup(q, x, q0, t, bp_coeffs, pub, coms), pub

    def verify_setup(self, tr, coms) -> BPSetup:
        # deliberately duplicates setup_from_challenges' count check: the
        # indexing below must not run on a short list (IndexError where
        # callers expect ValueError)
        if len(coms) != 4 + len(self.rds):
            raise ValueError("wrong commitment count")
        bl_com, r_com, dm_com, m_com = coms[0], coms[1], coms[2], coms[3]
        n_coms = coms[4:]
        e, x, r0 = (Fr(v) for v in tr.oracle([dm_com, m_com] + list(n_coms), 3))
        q, xp, r1 = (Fr(v) for v in tr.oracle([r_com], 3))
        t = Fr(tr.oracle([bl_com], 1)[0])
        return self.setup_from_challenges(coms, e, x, r0, q, xp, r1, t)[0]
