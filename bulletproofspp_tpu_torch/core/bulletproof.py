"""Generic bulletproof round engine: prover loop and one-MSM verifier.

(reference: src/Bulletproof.hs:322-379)

The prover performs ``rounds`` iterations of: compute cross-term scalars
and commitment frames, commit L and R (two MSMs), draw the challenge from
the transcript, fold the scalar, and collapse the witness/basis
(reference: proveRoundM, Bulletproof.hs:346-355).

The verifier replays the challenges from the L/R responses, tensor-expands
them over the original basis, and performs ONE zero-check MSM combining
the expanded exponents, the public constants, the opening of the initial
commitment, and the challenge-weighted responses
(reference: verifyBPM, Bulletproof.hs:362-379).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .fields import Fr
from .norm_linear import NormLinearNL, expand_challenges_nl
from .inner_product import NormLinearIP, expand_norm_ip, expand_linear_ip


@dataclass
class BPSetup:
    """Everything the round engine needs (SetupBP analog,
    reference: Bulletproof.hs:326)."""

    arg_cls: type  # NormLinearNL | NormLinearIP
    scalar_base: object  # g: base of the tracked scalar (PSV scalar base)
    q: Fr  # argument weight parameter
    bp_coeffs: list  # public linear coefficients
    pub_scalar: Fr  # public scalar component (verifier-side anchor)
    pub_nrm: list  # public norm constants
    pub_lin: list  # public linear constants (usually empty)
    nrm_bases: list
    lin_bases: list
    rounds: int
    init_pairs: list = field(default_factory=list)  # opening of the initial commitment


@dataclass
class BPProof:
    responses: list  # [(L, R)] in EXECUTION order (round 1 first)
    wit_scalars: list  # transmitted final opening: norm scalars ++ linear scalars


# Optional per-round trace hook for verbose mode (the reference's
# runVerbose re-runs the protocol printing per-phase evalScalar
# invariants, reference: app/Main.hs:214-239).  Called as
# trace(round_index, challenge, tracked_scalar, collapsed_arg).
_round_trace = None


def set_round_trace(fn):
    global _round_trace
    _round_trace = fn


def prove_bp(tr, engine, setup: BPSetup, wit_scalar: Fr, wit_nrm, wit_lin) -> BPProof:
    arg = setup.arg_cls.make(
        setup.q, setup.bp_coeffs, wit_nrm, setup.nrm_bases, wit_lin, setup.lin_bases, engine
    )
    if _round_trace is not None:
        _round_trace(-1, None, wit_scalar, arg)
    sb = engine.basevec_cached(setup.scalar_base)
    sc = wit_scalar
    responses = []
    for i in range(setup.rounds):
        s_l, l_groups, s_r, r_groups = arg.make_scalars_coms()
        # ONE device dispatch for both round commitments (fused L/R MSM)
        ac, bc = engine.msm_pair([([s_l], sb)] + l_groups, [([s_r], sb)] + r_groups)
        e = Fr(tr.oracle([ac, bc], 1)[0])
        e0, e1 = setup.arg_cls.make_es(e)
        sc = sc + e0 * s_l + e1 * s_r
        arg = arg.collapse(e, engine)
        responses.append((ac, bc))
        if _round_trace is not None:
            _round_trace(i, e, sc, arg)
    return BPProof(responses, arg.get_witness())


def verify_bp(tr, engine, setup: BPSetup, proof: BPProof) -> bool:
    pairs = verify_bp_pairs(tr, setup, proof)
    if pairs is None:
        return False
    return engine.msm(pairs) is None


def verify_bp_pairs(tr, setup: BPSetup, proof: BPProof):
    """The verifier's zero-check MSM as (scalar, point) pairs, or None on a
    malformed proof.  Exposed separately so batch verification can combine
    many proofs into ONE random-linear-combination MSM (the feature the
    reference lists as TODO, reference: src/RangeProof.hs:103-106,
    README.md:186)."""
    # structural validation first: a malformed proof must yield None, not a
    # crash (the reference's decode-side checks, src/RangeProof.hs:68-85,
    # guard the CLI path; library callers can hand us anything)
    try:
        responses = [(ac, bc) for ac, bc in proof.responses]
        wit = [Fr(int(s)) for s in proof.wit_scalars]
    except (TypeError, ValueError):
        return None
    if len(responses) != setup.rounds:
        return None

    # replay challenges in execution order (responses that are not lists
    # of curve points fail hashing => malformed, reject)
    try:
        es = [Fr(tr.oracle([ac, bc], 1)[0]) for ac, bc in responses]
    except (TypeError, ValueError, AttributeError, IndexError):
        return None

    n_nrm, n_lin = setup.arg_cls.optimal_witness_size(len(setup.nrm_bases), len(setup.lin_bases))[1]
    if len(wit) != n_nrm + n_lin:
        return None
    wit_nrm, wit_lin = wit[:n_nrm], wit[n_nrm:]

    pairs = list(setup.init_pairs)
    if setup.arg_cls is NormLinearNL:
        sc, coeff_n, coeff_l = expand_challenges_nl(
            es,
            wit_nrm,
            wit_lin,
            setup.q,
            setup.bp_coeffs,
            setup.pub_nrm,
            setup.pub_lin,
            len(setup.nrm_bases),
            len(setup.lin_bases),
        )
        pairs += list(zip(coeff_n, setup.nrm_bases))
        pairs += list(zip(coeff_l, setup.lin_bases))
    else:
        sc_n, pairs_n = expand_norm_ip(es, wit_nrm, setup.q, setup.pub_nrm, setup.nrm_bases)
        sc_l, coeff_l = expand_linear_ip(
            es, wit_lin, setup.bp_coeffs, setup.pub_lin, len(setup.lin_bases)
        )
        sc = sc_n + sc_l
        pairs += pairs_n
        pairs += list(zip(coeff_l, setup.lin_bases))

    pairs.append((setup.pub_scalar - sc, setup.scalar_base))
    for e, (ac, bc) in zip(es, responses):
        e0, e1 = setup.arg_cls.make_es(e)
        pairs.append((e0, ac))
        pairs.append((e1, bc))
    return pairs
