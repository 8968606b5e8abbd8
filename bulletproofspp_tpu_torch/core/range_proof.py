"""Range proofs: prove/verify orchestration + wire format.

(reference: src/RangeProof.hs)

A proof consists of the final witness scalars and the point list
[range-proof commitments] ++ [L/R responses in reverse round order]
(the reference accumulates responses last-round-first,
reference: Bulletproof.hs:357-359 + RangeProof.hs:60-66).  The input
value commitments travel in a separate commitments file.
"""

from __future__ import annotations

from dataclasses import dataclass

from .fields import Fr
from .transcript import Transcript
from .encoding import encode_scalars_points, encode_commitments
from .bulletproof import BPProof, verify_bp
from .engine import default_engine
from .utils import pairs as _pairs, unpairs as _unpairs


@dataclass
class RangeProof:
    rp_coms: list  # protocol commitments (blCom, ... )
    input_coms: list  # per-value commitments (separate coms file)
    bp: BPProof


def prove(setup, values, random_seed: bytes, engine=None) -> RangeProof:
    """Run the full prover (reference: RangeProof.hs:95-97)."""
    engine = engine or default_engine()
    wit = setup.witness(values)
    if wit is None:
        raise ValueError("invalid witness")
    tr = Transcript(random_seed)
    coms, _bp_setup, bp = setup.prove(tr, engine, values, wit)
    n_rp = setup.info()[0]
    return RangeProof(coms[:n_rp], coms[n_rp:], bp)


def verify(setup, rp: RangeProof, engine=None) -> bool:
    """Run the full verifier (reference: RangeProof.hs:99-101)."""
    engine = engine or default_engine()
    tr = Transcript(None)
    coms = list(rp.rp_coms) + list(rp.input_coms)
    try:
        bp_setup = setup.verify_setup(tr, coms)
    except (ValueError, TypeError, IndexError):
        # malformed structure (wrong commitment count/shape) => reject,
        # never raise (reference: src/RangeProof.hs:68-85 decode-side
        # validation; here the library API is hardened too)
        return False
    return verify_bp(tr, engine, bp_setup, rp.bp)


def encode_proof(setup, rp: RangeProof) -> tuple[bytes, bytes]:
    """Returns (coms_file_bytes, proof_file_bytes)
    (reference: RangeProof.hs:60-66, app/Main.hs:179-182)."""
    bp_coms = _unpairs(list(reversed(rp.bp.responses)))
    proof_bytes = encode_scalars_points(rp.bp.wit_scalars, list(rp.rp_coms) + bp_coms)
    coms_bytes = encode_commitments(rp.input_coms)
    return coms_bytes, proof_bytes


def parse_proof(setup, coms_bytes: bytes, proof_bytes: bytes):
    """Byte-level parse without any EC work: returns
    (scalars, rp_xs, input_xs) where *_xs are [(x, sign)] lists, or None
    on malformed bytes.  Batch verification parses many proofs, then
    decompresses EVERY point in one device call (the n=1024 showcase)."""
    from .encoding import parse_commitments

    num_rp, nrm_len, lin_len = setup.info()
    rounds, (n_nrm, n_lin) = setup.arg_cls.optimal_witness_size(nrm_len, lin_len)
    res = parse_commitments(setup.n_input_coms(), coms_bytes)
    if res is None:
        return None
    input_xs, _ = res
    s_n = n_nrm + n_lin
    if len(proof_bytes) < 32 * s_n:
        return None
    from .transcript import decode_scalar
    from . import ec as _ec

    scalars = [decode_scalar(proof_bytes[32 * i : 32 * i + 32], _ec.R) for i in range(s_n)]
    res = parse_commitments(num_rp + 2 * rounds, proof_bytes, 32 * s_n)
    if res is None:
        return None
    rp_xs, _ = res
    return scalars, rp_xs, input_xs


def assemble_proof(setup, scalars, rp_points, input_points):
    """Build a RangeProof from parsed scalars + decompressed point lists
    (None in a point list => invalid proof => returns None)."""
    if any(p is None for p in rp_points) or any(p is None for p in input_points):
        return None
    num_rp = setup.info()[0]
    rp_coms, bp_coms = rp_points[:num_rp], rp_points[num_rp:]
    responses = list(reversed(_pairs(bp_coms)))
    return RangeProof(rp_coms, list(input_points), BPProof(responses, [Fr(s) for s in scalars]))


def decode_proof(setup, coms_bytes: bytes, proof_bytes: bytes, engine=None):
    """Returns a RangeProof or None (reference: RangeProof.hs:68-85).
    With an engine, point decompression runs as one batched device sqrt."""
    parsed = parse_proof(setup, coms_bytes, proof_bytes)
    if parsed is None:
        return None
    scalars, rp_xs, input_xs = parsed
    if engine is None:
        engine = default_engine()
    all_xs = rp_xs + input_xs
    pts = engine.decompress([x for x, _ in all_xs], [s for _, s in all_xs])
    rp_points, input_points = pts[: len(rp_xs)], pts[len(rp_xs) :]
    return assemble_proof(setup, scalars, rp_points, input_points)
