"""Multiparty range proving — full-protocol MPC, both protocol families.

The port's copy of ``bulletproofspp_tpu/core/mp_prove.py``; the logic is
the same, line for line.  ``engine=None`` resolves through
``core.engine.default_engine()``, a ``TorchEngine`` on the CUDA card.

The reference defines transport-parametric dealer/client combinators but
never wires them to a prover (reference: src/ZKP.hs:106-131; the repo's
``multiparty.py`` realizes those combinators plus an aggregated-opening
PoK demo).  This module goes the rest of the way: N parties, each
holding the values of a DISJOINT subset of the ranges of one aggregated
schema — typed-reciprocal (src/RangeProof/TypedReciprocal.hs) or binary
(src/RangeProof/Binary.hs) — jointly produce ONE standard range proof
that verifies with the ordinary single-prover verifier against the
ordinary wire format (core/range_proof.py).

Why this decomposes cleanly (the "MPC cross-term" analysis):

* Every phase commitment (DM, M, R, BL and the per-value N_i) is LINEAR
  in the per-party witness/blinding shares, so the dealer's elementwise
  group-sum (reference: ZKP.hs:129 ``zipWith (^+^)``) of per-party
  commitments equals the single-prover commitment of the summed witness.
* The blinding-phase error terms (``make_error_terms``) are quadratic,
  but PER ROW of the norm vector — and every norm row (typing row or
  digit row) is owned by exactly one party.  Provided each party's norm
  blinding ``bls_nrm`` is supported ONLY on its own rows, each row's
  quadratic contribution is computed entirely by its owner and the error
  sums are additive.  (Shared-multiplicity linear slots enter the error
  terms linearly, so those MAY be blinded by every party.)
* ``blind_blinding_term`` is linear in (blinding, error terms, phase
  witnesses, input blind) for fixed public challenges, so the final
  blinding commitments also sum correctly.
* The bulletproof rounds (quadratic cross terms across the fold halves)
  are run by the DEALER on the summed post-challenge witness
  ``sum_i W_i`` — each coordinate of a party's share ``W_i`` is masked
  by that party's private blinding, exactly the quantity the BP++
  single-round blinding protocol is designed to make simulatable.

Trust model (same as dalek-bulletproofs' MPC party/dealer API): the
dealer is trusted for PRIVACY (it sees the blinded witness shares W_i;
an outside observer of the wire sees only commitments + the final
proof), but NOT for soundness — the proof verifies against the
aggregate commitments under plain Fiat-Shamir, so a cheating dealer can
only produce an invalid proof.  Parties are cooperating provers of a
joint statement (honest-but-curious), matching the reference's dealer
aggregation semantics.  Type conservation for typed schemas is a JOINT
property; it cannot be checked by any single party, and a violated
conservation surfaces as the final proof failing verification.

Party ordering note: the dealer requires every range to be owned by
exactly one party; an unowned range leaves the identity in the summed
input-commitment vector and the transcript refuses to absorb it
(core/transcript.py `_coords`), aborting the protocol rather than
producing an unsound proof.

With a single party owning every range, the produced proof is
BYTE-IDENTICAL to the single-prover ``SetupTRRP.prove`` output for the
same seed (pinned by tests/test_torch_mp_prove.py) — the MPC decomposition is
exact, not merely "also verifies".
"""

from __future__ import annotations

from .fields import Fr, batch_inverse
from .utils import pad_right
from .engine import default_engine
from .transcript import Transcript
from .range_proof import RangeProof
from .bulletproof import prove_bp
from .multiparty import ClientOracle, run_dealer
from .rp_internal import RPW, blind_blinding_term, blind_err_witness, blind_witness
from .typed_reciprocal import (
    Ph1,
    _nrm_rows,
    base_mss,
    err7_term,
    input_coeffs_t,
    make_error_terms,
    make_phase1s,
    make_phase2s,
    make_shared_coeffs,
    NUM_TERMS,
)


def row_layout(setup):
    """Global norm-row layout of the aggregated witness: typing rows for
    all ranges first (when typed), then each range's digit rows
    (mirrors SetupTRRP.witness's ``types + concat ph1ss`` ordering)."""
    n_typing = len(setup.rds) if setup.has_types else 0
    offsets = []
    off = n_typing
    for rd in setup.rds:
        offsets.append(off)
        off += _nrm_rows(rd)
    assert off == setup.nrm_len, "row layout disagrees with setup.nrm_len"
    return n_typing, offsets


def _scatter(indices, values, length):
    out = [Fr(0)] * length
    for i, v in zip(indices, values):
        out[i] = v
    return out


def party_prove(setup, channel, owned: dict, seed: bytes, engine=None):
    """One party's side of the multiparty prover.

    ``setup``: the FULL aggregated setup (public) — SetupTRRP or
    SetupBRP; dispatches on the protocol family.
    ``owned``: {range_index: values} for the ranges this party holds
    (``((amount, type), blind)`` for typed-reciprocal, ``(amount,
    blind)`` for binary); every other index must be held by exactly one
    other party.  ``channel``: client endpoint (LocalChannel /
    SocketChannel).  ``seed``: party-private randomness seed (never
    shared).
    """
    from .binary_rp import SetupBRP

    if isinstance(setup, SetupBRP):
        return _party_prove_brp(setup, channel, owned, seed, engine)
    return _party_prove_trrp(setup, channel, owned, seed, engine)


def dealer_prove(setup, channels, engine=None) -> RangeProof:
    """Dealer side: aggregate per-party commitments through the generic
    dealer loop (core/multiparty.py run_dealer — the reference's
    multiPartyDealer, ZKP.hs:124-131), then finish the proof by running
    the bulletproof rounds on the summed blinded witness.

    Returns a standard RangeProof that core/range_proof.verify accepts
    against the aggregated commitments.  Dispatches on the protocol
    family (SetupTRRP / SetupBRP).
    """
    from .binary_rp import SetupBRP

    if isinstance(setup, SetupBRP):
        return _dealer_prove_brp(setup, channels, engine)
    return _dealer_prove_trrp(setup, channels, engine)


def _party_prove_trrp(setup, channel, owned: dict, seed: bytes, engine=None):
    """Typed-reciprocal party: mirrors SetupTRRP.prove (reference:
    TypedReciprocal.hs:399-444) phase-for-phase, with all vectors
    scattered into the GLOBAL layout (zero outside this party's rows) so
    the dealer's elementwise sums reproduce the single-prover aggregate
    exactly.
    """
    engine = engine or default_engine()
    tr = Transcript(seed)  # local randomness only; challenges come from the dealer
    oracle = ClientOracle(channel)
    arg = setup.arg_cls
    n_ranges = len(setup.rds)
    if not owned or any(not (0 <= i < n_ranges) for i in owned):
        raise ValueError("owned range indices out of bounds")
    n_typing, offsets = row_layout(setup)

    # ---- phase 1: rows for owned ranges at their global positions ----
    rows = []  # (global_row_index, Ph1) in local deterministic order
    mss_owned, bases_owned, bits_owned = [], [], []
    owned_sorted = sorted(owned)
    for i in owned_sorted:
        rd = setup.rds[i]
        (v, tt), _bl = owned[i]
        if setup.has_types:
            rows.append(
                (
                    i,
                    Ph1(
                        "typing",
                        i,
                        is_output=rd.is_output,
                        is_assumed=rd.is_assumed,
                        v_amt=Fr(v),
                        t_type=Fr(tt),
                    ),
                )
            )
        res = make_phase1s(i, rd, Fr(v))
        if res is None:
            raise ValueError(f"invalid witness for range {i}")
        ph1s_i, ms = res
        rows.extend((offsets[i] + j, r) for j, r in enumerate(ph1s_i))
        mss_owned.append(ms)
        bases_owned.append(rd.base)
        bits_owned.append(rd.has_bit)
    # global row order (typing rows first, then digit rows by range):
    # blinding randoms are drawn in row order, so this makes the one-party
    # case draw-for-draw identical to the single prover
    rows.sort(key=lambda gr: gr[0])
    g_idx = [g for g, _ in rows]
    ph1s = [r for _, r in rows]

    # shared multiplicities, scattered into the setup's m_bases layout
    acc = dict(base_mss(mss_owned, bases_owned, bits_owned))
    ms_shared = []
    for b in setup.m_bases:
        vec = acc.pop(b, [])
        ms_shared += pad_right(b - 1, Fr(0), list(vec))[: b - 1]
    assert not acc, "witness shared base absent from setup.m_bases"

    ds, ms_inline = [], []
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
    ds_full = _scatter(g_idx, ds, setup.nrm_len)
    ms_inline_full = _scatter(g_idx, ms_inline, setup.nrm_len)

    n_wits = {
        i: RPW(Fr(owned[i][0][0]), [Fr(owned[i][0][1]), Fr(owned[i][1])], [])
        for i in owned_sorted
    }
    dm_wit = blind_witness(tr, NUM_TERMS, 2, ms_shared, ds_full)
    m_wit = blind_witness(tr, NUM_TERMS, 1, [], ms_inline_full)
    coms = setup.commit_many(engine, [n_wits[i] for i in owned_sorted] + [dm_wit, m_wit])
    n_coms, dm_com, m_com = coms[:-2], coms[-2], coms[-1]
    n_coms_sparse = [None] * n_ranges
    for i, c in zip(owned_sorted, n_coms):
        n_coms_sparse[i] = c

    e, x, r0 = (Fr(v) for v in oracle.oracle([dm_com, m_com] + n_coms_sparse, 3))
    e_inv, r0_inv = batch_inverse([e, r0])

    # ---- phase 2: reciprocals for owned rows only ----
    base_map = setup.base_map(x)
    ph2s = make_phase2s(True, setup.has_types, e, e_inv, x, base_map, ph1s)
    err7 = r0_inv * (-err7_term(ph2s))
    r_wit = blind_err_witness(
        tr, NUM_TERMS, [err7], [], _scatter(g_idx, [p.r for p in ph2s], setup.nrm_len)
    )
    r_com = setup.commit(engine, r_wit)

    q, xp, r1 = (Fr(v) for v in oracle.oracle([r_com], 3))
    q_pows_full = arg.q_powers(q, setup.nrm_len)
    q0 = q_pows_full[0]
    q0_inv, r1_inv = batch_inverse([q0, r1])
    shared_cs = make_shared_coeffs(e, e_inv, setup.m_bases, base_map)
    t_c = xp if setup.has_types else Fr(0)

    # ---- phase 3: blinding.  Linear slots (bl_t + shared multiplicity
    # slots) are blinded by EVERY party (they enter the error terms
    # linearly); norm rows are blinded ONLY by their owner (they enter
    # quadratically — see module docstring).
    bls_lin = [Fr(v) for v in tr.randoms(setup.lin_len - 5)]
    bls_nrm_owned = [Fr(v) for v in tr.randoms(len(rows))]
    bls_nrm = _scatter(g_idx, bls_nrm_owned, setup.nrm_len)
    bl_bls = RPW(Fr(0), bls_lin, bls_nrm)
    bls_ms = bls_lin[1:]

    is_as = [rd.is_assumed for rd in setup.rds]
    ics = input_coeffs_t(setup.has_types, is_as, x, q0)
    n_wit_sum = RPW.zero()
    for i in owned_sorted:
        n_wit_sum = n_wit_sum + n_wits[i].scale(ics[i])
    input_bl = n_wit_sum.lin[1] if n_wit_sum.lin else Fr(0)
    errs = make_error_terms(
        e, xp, shared_cs, bls_ms, ph2s, [q_pows_full[g] for g in g_idx], bls_nrm_owned
    )
    bl_wit = blind_blinding_term(
        bl_bls, t_c, (r0, r0_inv), (r1, r1_inv), errs, [m_wit, dm_wit, r_wit], input_bl
    )
    bl_com = setup.commit(engine, bl_wit)
    t = Fr(oracle.oracle([bl_com], 1)[0])

    # ---- phase 4: this party's additive share of the BP witness ----
    w = (
        bl_wit
        + m_wit.scale(t)
        + dm_wit.scale(t * t)
        + r_wit.scale(t**3)
        + n_wit_sum.scale(2 * t**5)
    )
    lin = pad_right(setup.lin_len, Fr(0), list(w.lin))
    nrm = pad_right(setup.nrm_len, Fr(0), list(w.nrm))
    oracle.done([int(w.sc)] + [int(v) for v in lin] + [int(v) for v in nrm])


def _dealer_prove_trrp(setup, channels, engine=None) -> RangeProof:
    engine = engine or default_engine()
    tr = Transcript(None)  # prove_bp draws no prover randomness
    summed, rounds, challenges = run_dealer(channels, tr)
    if len(rounds) != 3 or [len(r) for r in rounds[1:]] != [1, 1]:
        raise ValueError("unexpected multiparty round structure")
    dm_com, m_com, *n_coms = rounds[0]
    (r_com,), (bl_com,) = rounds[1], rounds[2]
    e, x, r0 = (Fr(v) for v in challenges[0])
    q, xp, r1 = (Fr(v) for v in challenges[1])
    t = Fr(challenges[2][0])

    coms = [bl_com, r_com, dm_com, m_com] + list(n_coms)
    bp_setup, pub = setup.setup_from_challenges(coms, e, x, r0, q, xp, r1, t)

    if len(summed) != 1 + setup.lin_len + setup.nrm_len:
        raise ValueError("witness share length mismatch")
    share = RPW(
        Fr(summed[0]),
        [Fr(v) for v in summed[1 : 1 + setup.lin_len]],
        [Fr(v) for v in summed[1 + setup.lin_len :]],
    )
    w = pub + share
    proof = prove_bp(tr, engine, bp_setup, w.sc, w.nrm, w.lin)
    n_rp = setup.info()[0]
    return RangeProof(coms[:n_rp], coms[n_rp:], proof)


# ---------------------------------------------------------------------------
# Binary range proof (reference: src/RangeProof/Binary.hs) — the same
# decomposition, simpler: digit rows are owner-disjoint, the blinding
# polynomial terms |bls|^2_q and 2<bls, d + pub>_q are per-row products
# (make_poly_terms), and the blinding commitment is linear in the
# shares.  Conservation (``cons``) is a joint property enforced by the
# x-weighted input coefficients in the argument itself: a violated
# conservation yields a proof that fails verification.
# ---------------------------------------------------------------------------


def _party_prove_brp(setup, channel, owned: dict, seed: bytes, engine=None):
    """Binary-protocol party: mirrors SetupBRP.prove (reference:
    Binary.hs:171-204).  ``owned``: {range_index: (amount, blind)}."""
    from .binary_rp import make_digits_binary, make_public_consts_binary, input_coeffs_binary

    engine = engine or default_engine()
    tr = Transcript(seed)
    oracle = ClientOracle(channel)
    arg = setup.arg_cls
    n_ranges = len(setup.rds)
    if not owned or any(not (0 <= i < n_ranges) for i in owned):
        raise ValueError("owned range indices out of bounds")
    # assumed binary ranges commit no digits (make_digits_binary -> []):
    # the committed digit rows are COMPACTED — later ranges' digits do
    # not skip assumed slots.  SetupBRP.nrm_len still counts assumed
    # ranges, so the single prover draws blinding for a SURPLUS TAIL of
    # rows beyond the digits (its |bls|^2_q enters bl0_sc quadratically,
    # its cross term with dp truncates away).  Assign each assumed
    # range's tail block to its OWNER so exactly one party blinds each
    # tail row and the quadratic bl0_sc stays additive.
    offsets, off = [], 0
    for rd in setup.rds:
        offsets.append(off)
        off += 0 if rd.is_assumed else len(rd.base_coeffs)
    tail_offsets, t_off = {}, off
    for i, rd in enumerate(setup.rds):
        if rd.is_assumed:
            tail_offsets[i] = t_off
            t_off += len(rd.base_coeffs)
    assert t_off == setup.nrm_len

    owned_sorted = sorted(owned)
    g_idx, ds = [], []
    bl_rows = []  # global indices of rows THIS party blinds
    for i in owned_sorted:
        rd = setup.rds[i]
        v, _bl = owned[i]
        d = make_digits_binary(rd, int(Fr(v)))
        if d is None:
            raise ValueError(f"invalid witness for range {i}")
        g_idx += list(range(offsets[i], offsets[i] + len(d)))
        ds += [Fr(x) for x in d]
        if rd.is_assumed:
            bl_rows += list(range(tail_offsets[i], tail_offsets[i] + len(rd.base_coeffs)))
        else:
            bl_rows += list(range(offsets[i], offsets[i] + len(rd.base_coeffs)))
    ds_full = _scatter(g_idx, ds, setup.nrm_len)

    n_wits = {i: RPW(Fr(owned[i][0]), [Fr(owned[i][1])], []) for i in owned_sorted}
    s_bl, l_bl0 = (Fr(v) for v in tr.randoms(2))
    d_wit = RPW(s_bl, [l_bl0, Fr(0)], ds_full)
    coms = setup.commit_many(engine, [n_wits[i] for i in owned_sorted] + [d_wit])
    n_coms, d_com = coms[:-1], coms[-1]
    n_coms_sparse = [None] * n_ranges
    for i, c in zip(owned_sorted, n_coms):
        n_coms_sparse[i] = c

    q, x, r = (Fr(v) for v in oracle.oracle([d_com] + n_coms_sparse, 3))
    r_inv = r.inv()
    q_pows = arg.q_powers(q, setup.nrm_len)
    q0 = q_pows[0]
    pub = make_public_consts_binary(setup.cons, setup.net_pub, x, q0, q0.inv(), setup.rds)

    # draw in GLOBAL row order (digit + tail interleaved by index): with
    # one party owning everything this is draw-for-draw the single
    # prover's bls_nrm = randoms(nrm_len)
    bl_rows.sort()
    bls_map = {g: Fr(v) for g, v in zip(bl_rows, tr.randoms(len(bl_rows)))}
    bls_nrm = [bls_map.get(g, Fr(0)) for g in range(setup.nrm_len)]
    bl_bl = Fr(tr.random())
    # per-row quadratics: each row's blinding (and each digit row's
    # d + pub.nrm) pairs only with its OWNER's values, so both poly-term
    # sums are additive across parties (reference poly terms:
    # Internal.hs:65-76 via Binary.hs:184-189)
    bl0_sc = Fr(0)
    for g in bl_rows:
        bl0_sc = bl0_sc + q_pows[g] * bls_map[g] * bls_map[g]
    bl1_sc = Fr(0)
    for d, g in zip(ds, g_idx):
        dp = d + (pub.nrm[g] if g < len(pub.nrm) else Fr(0))
        bl1_sc = bl1_sc + 2 * q_pows[g] * bls_map[g] * dp
    bl_wit = RPW(bl0_sc, [bl_bl, r_inv * (s_bl - bl1_sc)], bls_nrm)
    bl_com = setup.commit(engine, bl_wit)
    t = Fr(oracle.oracle([bl_com], 1)[0])

    ics = input_coeffs_binary(setup.cons, setup.rds, x)
    acc = RPW.zero()
    for i in owned_sorted:
        acc = acc + n_wits[i].scale(ics[i])
    w = bl_wit + d_wit.scale(t) + acc.scale(2 * t * t)
    lin = pad_right(2, Fr(0), list(w.lin))
    nrm = pad_right(setup.nrm_len, Fr(0), list(w.nrm))
    oracle.done([int(w.sc)] + [int(v) for v in lin] + [int(v) for v in nrm])


def _dealer_prove_brp(setup, channels, engine=None) -> RangeProof:
    engine = engine or default_engine()
    tr = Transcript(None)
    summed, rounds, challenges = run_dealer(channels, tr)
    if len(rounds) != 2 or len(rounds[1]) != 1:
        raise ValueError("unexpected multiparty round structure")
    d_com, *n_coms = rounds[0]
    (bl_com,) = rounds[1]
    q, x, r = (Fr(v) for v in challenges[0])
    t = Fr(challenges[1][0])

    coms = [bl_com, d_com] + list(n_coms)
    bp_setup, pub_t2 = setup.setup_from_challenges(coms, q, x, r, t)
    if len(summed) != 3 + setup.nrm_len:
        raise ValueError("witness share length mismatch")
    share = RPW(Fr(summed[0]), [Fr(summed[1]), Fr(summed[2])], [Fr(v) for v in summed[3:]])
    w = pub_t2 + share
    proof = prove_bp(tr, engine, bp_setup, w.sc, w.nrm, w.lin)
    n_rp = setup.info()[0]
    return RangeProof(coms[:n_rp], coms[n_rp:], proof)
