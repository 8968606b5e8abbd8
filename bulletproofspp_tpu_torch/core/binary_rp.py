"""Binary range proof (reference: src/RangeProof/Binary.hs).

Digits d in {0,1} are committed once; the norm argument checks d(d-1)=0
via the completed square |(-1/2) + d|^2 terms.  Three phases: commit the
digit vector D and per-value commitments N_j; draw (q, x, r); commit the
blinding vector B with inline error terms |bl + t*d|^2_q = e0 + e1*t +
|d|^2 t^2; draw t; hand off to the bulletproof with witness
B + t*(pub + D + 2t sum x^{2j} N_j).
"""

from __future__ import annotations

from dataclasses import dataclass

from .fields import Fr
from .utils import integer_log, base_digits, pad_left, take_maybe
from .rp_internal import RPW, commit_rpw, make_poly_terms
from .bulletproof import BPSetup, prove_bp


@dataclass
class RangeDataB:
    """(reference: Binary.hs:37-54)."""

    min: int
    max: int
    is_output: bool
    is_assumed: bool
    base_coeffs: list


def make_range_data_binary(char: int, rmin: int, rmax: int, is_o: bool, is_a: bool):
    if not (rmax > rmin and rmax - rmin < char):
        return None
    n1 = integer_log(2, rmax - rmin - 1)
    bn = (rmax - rmin) - (1 << n1)
    bs = [1 << (n1 - i) for i in range(1, n1 + 1)]
    return RangeDataB(rmin, rmax, is_o, is_a, [bn] + bs)


def make_digits_binary(rd: RangeDataB, v: int):
    """v is the witness as a field value; the adjusted value lifts the field
    difference v - min to [0, R) (reference: Binary.hs:56-69)."""
    if rd.is_assumed:
        return []
    n_adj = int(Fr(v) - Fr(rd.min))
    if not (0 <= n_adj < rd.max - rd.min):
        return None
    n1 = integer_log(2, rd.max - rd.min - 1)
    bn = rd.base_coeffs[0]
    # D2 (docs/UPSTREAM_SEMANTICS.md): take the top digit whenever the
    # remainder would not fit in n1 bits.  Upstream's strict `nAdj > bn`
    # (Binary.hs:63) leaves n_adj == bn == 2^n1 — the exact midpoint of a
    # power-of-two range — with an (n1+1)-bit remainder; its padLeft
    # never truncates (Utils.hs:77), the digit vector gains a row, and
    # the concatenated layout shifts: honest proofs never verify.  The
    # condition below differs from upstream ONLY in that broken case.
    if n_adj > bn or n_adj >= (1 << n1):
        dn, n_adj = 1, n_adj - bn
    else:
        dn = 0
    return [dn] + pad_left(n1, 0, base_digits(2, n_adj))


def input_coeffs_binary(cons: bool, rds, x: Fr):
    """(reference: Binary.hs:128-130)."""
    out = []
    x2 = x * x
    p = x2
    for rd in rds:
        c = Fr(0) if rd.is_assumed else p
        if cons:
            c = c + (-x if rd.is_output else x)
        out.append(c)
        p = p * x2
    return out


def make_public_consts_binary(cons: bool, net_pub: int, x: Fr, q0: Fr, q0inv: Fr, rds):
    """(reference: Binary.hs:72-94)."""
    x2 = x * x
    bss = []
    p = x2
    for rd in rds:
        if not rd.is_assumed:
            bss += [p * Fr(b) for b in rd.base_coeffs]
        p = p * x2
    mins = [Fr(0) if rd.is_assumed else Fr(rd.min) for rd in rds]
    net_pub_c = (-x) * Fr(net_pub) if cons else Fr(0)
    xp = x2
    acc = net_pub_c
    for m in mins:
        acc = acc + m * xp
        xp = xp * x2
    sc = Fr(-2) * acc
    neg_half = -(Fr(2).inv())
    nrm = []
    q2, q2inv = q0, q0inv
    for bx in bss:
        pv = neg_half + bx * q2inv
        sc = sc + q2 * pv * pv
        nrm.append(pv)
        q2 = q2 * q0
        q2inv = q2inv * q0inv
    return RPW(sc, [], nrm)


@dataclass
class SetupBRP:
    """(reference: Binary.hs:132-156)."""

    arg_cls: type
    nrm_len: int
    rds: list
    net_pub: int
    cons: bool
    h: object
    g: object
    h0: object
    h1: object
    gs: list

    @classmethod
    def make(cls, arg_cls, points, cons: bool, rds, net_pub: int):
        nrm_len = sum(len(rd.base_coeffs) for rd in rds)
        head = take_maybe(4, points)
        if head is None:
            return None
        h, g, h0, h1 = head
        gs = take_maybe(nrm_len, points[4:])
        if gs is None:
            return None
        return cls(arg_cls, nrm_len, rds, net_pub, cons, h, g, h0, h1, gs)

    # -- commitment helpers --------------------------------------------------
    def commit(self, engine, w: RPW):
        return commit_rpw(engine, w, self.g, self._hs(), self.gs)

    def commit_many(self, engine, ws):
        from .rp_internal import commit_rpw_many

        return commit_rpw_many(engine, ws, self.g, self._hs(), self.gs)

    def _hs(self):
        # stable list object so engines can cache the packed base vector
        hs = getattr(self, "_hs_list", None)
        if hs is None:
            hs = [self.h0, self.h1]
            self._hs_list = hs
        return hs

    def info(self):
        """(numRpComs, nrmLen, linLen) (reference: Binary.hs:120)."""
        return 2, self.nrm_len, 2

    def n_input_coms(self):
        return len(self.rds)

    def _bp_setup(self, q: Fr, r: Fr, x: Fr, t: Fr, pub: RPW, coms) -> BPSetup:
        rounds = self.arg_cls.optimal_witness_size(self.nrm_len, 2)[0]
        bl_com, d_com, n_coms = coms[0], coms[1], coms[2:]
        ics = input_coeffs_binary(self.cons, self.rds, x)
        init_pairs = [(Fr(1), bl_com), (t, d_com)] + [
            (2 * t * t * c, nc) for c, nc in zip(ics, n_coms)
        ]
        return BPSetup(
            arg_cls=self.arg_cls,
            scalar_base=self.g,
            q=q,
            bp_coeffs=[Fr(0), r * t],
            pub_scalar=pub.sc,
            pub_nrm=pub.nrm,
            pub_lin=[],
            nrm_bases=self.gs,
            lin_bases=[self.h0, self.h1],
            rounds=rounds,
            init_pairs=init_pairs,
        )

    # -- witness -------------------------------------------------------------
    def witness(self, values):
        """values: [(amount Fr-int, blind Fr-int)].

        NOTE: the reference rejects any witness unless ``cons`` is set AND
        the amounts conserve (reference: Binary.hs:162-168 uses
        ``cons && sum == 0``); we apply the conservation check only when
        ``cons`` is set, which is the evident intent.
        """
        if self.cons:
            s = Fr(self.net_pub)
            for rd, (v, _) in zip(self.rds, values):
                s = s + (-Fr(v) if rd.is_output else Fr(v))
            if int(s) != 0:
                return None
        ds = []
        for rd, (v, _) in zip(self.rds, values):
            d = make_digits_binary(rd, int(v))
            if d is None:
                return None
            ds += d
        return ds

    # -- prover ---------------------------------------------------------------
    def prove(self, tr, engine, values, ds):
        """(reference: Binary.hs:171-204). Returns (coms, bp_setup, proof)."""
        arg = self.arg_cls
        n_wits = [RPW(Fr(v), [Fr(bl)], []) for v, bl in values]
        s_bl, l_bl0 = (Fr(v) for v in tr.randoms(2))
        d_wit = RPW(s_bl, [l_bl0, Fr(0)], [Fr(d) for d in ds])
        # all Phase-1 commitments precede ONE oracle call: fuse dispatches
        coms = self.commit_many(engine, n_wits + [d_wit])
        n_coms, d_com = coms[:-1], coms[-1]
        q, x, r = (Fr(v) for v in tr.oracle([d_com] + n_coms, 3))
        r_inv = r.inv()
        q_pows = arg.q_powers(q, self.nrm_len)
        q0 = q_pows[0]
        q0inv = q0.inv()

        pub = make_public_consts_binary(self.cons, self.net_pub, x, q0, q0inv, self.rds)
        bls_nrm = [Fr(v) for v in tr.randoms(self.nrm_len)]
        bl_bl = Fr(tr.random())
        dp = (d_wit + pub).nrm
        bl0_sc, bl1_sc, _ = make_poly_terms(q_pows, [bls_nrm, dp])
        bl_wit = RPW(bl0_sc, [bl_bl, r_inv * (s_bl - bl1_sc)], bls_nrm)
        bl_com = self.commit(engine, bl_wit)
        t = Fr(tr.oracle([bl_com], 1)[0])

        coms = [bl_com, d_com] + n_coms
        pub_t = RPW(t * pub.sc, [], pub.nrm)
        ics = input_coeffs_binary(self.cons, self.rds, x)
        acc = RPW.zero()
        for c, w in zip(ics, n_wits):
            acc = acc + w.scale(c)
        wit_p = pub_t + d_wit + acc.scale(2 * t)
        bp_wit = bl_wit + wit_p.scale(t)

        bp_setup = self._bp_setup(q, r, x, t, pub_t.scale(t), coms)
        proof = prove_bp(tr, engine, bp_setup, bp_wit.sc, bp_wit.nrm, bp_wit.lin)
        return coms, bp_setup, proof

    # -- verifier --------------------------------------------------------------
    def setup_from_challenges(self, coms, q, x, r, t) -> tuple:
        """Verifier-side BPSetup assembly given the challenges; shared by
        ``verify_setup`` and the multiparty dealer (core/mp_prove.py).
        Returns ``(bp_setup, pub_t2)`` — pub_t2 is the public RPW the
        dealer adds to the summed witness shares."""
        if len(coms) != 2 + len(self.rds):
            raise ValueError("wrong commitment count")
        q0 = self.arg_cls.q_powers(q, 1)[0]
        q0inv = q0.inv()
        pub = make_public_consts_binary(self.cons, self.net_pub, x, q0, q0inv, self.rds)
        pub_t2 = RPW(t * t * pub.sc, [], [t * v for v in pub.nrm])
        return self._bp_setup(q, r, x, t, pub_t2, coms), pub_t2

    def verify_setup(self, tr, coms) -> BPSetup:
        """(reference: Binary.hs:206-221)."""
        # deliberately duplicates setup_from_challenges' count check: the
        # indexing below must not run on a short list (IndexError where
        # callers expect ValueError)
        if len(coms) != 2 + len(self.rds):
            raise ValueError("wrong commitment count")
        bl_com, d_com, n_coms = coms[0], coms[1], coms[2:]
        q, x, r = (Fr(v) for v in tr.oracle([d_com] + list(n_coms), 3))
        t = Fr(tr.oracle([bl_com], 1)[0])
        return self.setup_from_challenges(coms, q, x, r, t)[0]
