"""Batch verification: N proofs -> ONE random-linear-combination MSM.

The reference lists batch verification as unimplemented future work
(reference: README.md:186 "Batch verification of multiple proofs",
src/RangeProof.hs:103-106, src/RangeProof/TypedReciprocal.hs:469-473).
This module implements it as the flagship multi-chip workload (SURVEY §2:
"random-linear-combination batch verifier: N proofs → one giant MSM
sharded across a pod slice").

Soundness: each proof's zero-check MSM Z_i must be the identity; checking
sum_i rho_i * Z_i == identity for rho_i that are unpredictable *to the
prover* accepts a batch containing an invalid proof with probability 1/r.
The rho_i are therefore derived Fiat-Shamir style from a hash over the
serialized bytes of EVERY proof in the batch (plus an optional caller
seed): an adversary contributing proofs to the batch cannot choose error
terms E_i with sum(rho_i * E_i) == identity without predicting rhos that
depend on its own final proof bytes.  Scalars for repeated basis points
are merged on host so the combined MSM stays near the size of a single
verification for same-schema batches.
"""

from __future__ import annotations

import hashlib

from .bulletproof import verify_bp_pairs
from .fields import R
from .transcript import Transcript, decode_scalar


def _batch_digest(items, seed: bytes) -> bytes:
    """SHA-256 over the serialized bytes of every proof in the batch.

    Binding the linear-combination weights to the full batch contents is
    what makes them verifier randomness in the Fiat-Shamir sense; a fixed
    or index-only seed would be predictable to the prover (any prover
    contributing >= 2 proofs could then cancel invalid terms)."""
    from .range_proof import encode_proof

    return _blob_digest(
        b"bppp batch rlc v1", seed, [encode_proof(setup, rp) for setup, rp in items]
    )


def _rhos(n: int, digest: bytes):
    """Per-proof weights rho_i = H(batch digest, i) | 1, reduced into
    [1, R-1].  Forcing the low bit makes the raw value nonzero, but
    decode_scalar can return R-1 and (R-1)|1 == R == 0 mod R — the
    reduction plus a counter re-hash guarantees a nonzero weight in the
    field (the re-hash fires with probability ~2^-256)."""
    out = []
    for i in range(n):
        ctr = 0
        while True:
            suffix = str(i).encode() if ctr == 0 else f"{i}.{ctr}".encode()
            rho = (decode_scalar(hashlib.sha256(b"batch " + digest + suffix).digest(), R) | 1) % R
            if rho:
                out.append(rho)
                break
            ctr += 1
    return out


def _merged_zero_check(items, rhos, engine) -> bool:
    """Shared rho-weighted merge + single zero-check MSM.

    items: list of (setup, RangeProof) already structurally validated OR
    not — each proof's transcript replay happens here and a structurally
    invalid proof rejects the whole batch.  The merge itself is
    _check_subset, the ONE implementation of the rho-weighted
    combination (soundness-relevant: a second copy would have to be
    kept bit-identical)."""
    collected = []
    for setup, rp in items:
        pairs = collect_pairs(setup, rp)
        if pairs is None:
            return False
        collected.append(pairs)
    return _check_subset(collected, rhos, range(len(collected)), engine)


def _blob_digest(tag: bytes, seed: bytes, blobs) -> bytes:
    """SHA-256 over length-prefixed (coms_bytes, proof_bytes) pairs."""
    h = hashlib.sha256(tag)
    h.update(seed)
    blobs = list(blobs)
    h.update(len(blobs).to_bytes(8, "big"))
    for coms_bytes, proof_bytes in blobs:
        h.update(len(coms_bytes).to_bytes(8, "big"))
        h.update(coms_bytes)
        h.update(len(proof_bytes).to_bytes(8, "big"))
        h.update(proof_bytes)
    return h.digest()


def collect_pairs(setup, rp):
    """One proof's zero-check MSM pairs (transcript replay only, no EC
    work), or None if the proof is structurally invalid."""
    tr = Transcript(None)
    # the whole replay sits inside the try: a hand-built RangeProof with
    # non-iterable coms or a malformed bp must return None, not raise
    try:
        coms = list(rp.rp_coms) + list(rp.input_coms)
        bp_setup = setup.verify_setup(tr, coms)
        return verify_bp_pairs(tr, bp_setup, rp.bp)
    except (ValueError, TypeError, IndexError, AttributeError):
        return None


def batch_verify(items, engine=None, seed: bytes = b"") -> bool:
    """items: iterable of (setup, RangeProof).  True iff ALL proofs verify
    (up to the 1/r soundness error of the linear combination)."""
    from .engine import default_engine

    engine = engine or default_engine()
    items = list(items)
    if not items:
        return True
    # structural validation of every proof FIRST (a malformed proof must
    # reject the batch, and must do so before serialization for the rho
    # digest can trip over it); the collected pairs are reused for the
    # merged check so the transcript replay runs once per proof
    collected = []
    for setup, rp in items:
        pairs = collect_pairs(setup, rp)
        if pairs is None:
            return False
        collected.append(pairs)
    rhos = _rhos(len(items), _batch_digest(items, seed))
    return _check_subset(collected, rhos, range(len(collected)), engine)


def batch_verify_encoded(entries, engine=None, seed: bytes = b"") -> bool:
    """Decode-and-batch-verify straight from wire bytes — the 1024-proof
    showcase path.  entries: iterable of (setup, coms_bytes, proof_bytes).

    Point decompression for ALL proofs runs as ONE batched device sqrt
    (engine.decompress) instead of ~14k Python pows; the rho weights are
    derived from the raw input bytes; the zero checks then merge into one
    MSM as in batch_verify.  True iff every proof decodes and verifies.
    """
    from .engine import default_engine
    from .range_proof import parse_proof, assemble_proof

    engine = engine or default_engine()
    entries = list(entries)
    if not entries:
        return True

    parsed = []
    all_xs: list = []
    for setup, coms_bytes, proof_bytes in entries:
        p = parse_proof(setup, coms_bytes, proof_bytes)
        if p is None:
            return False
        scalars, rp_xs, input_xs = p
        parsed.append((setup, scalars, len(rp_xs), len(input_xs)))
        all_xs += rp_xs + input_xs

    pts = engine.decompress([x for x, _ in all_xs], [s for _, s in all_xs])

    items = []
    off = 0
    for setup, scalars, n_rp, n_in in parsed:
        rp = assemble_proof(setup, scalars, pts[off : off + n_rp], pts[off + n_rp : off + n_rp + n_in])
        off += n_rp + n_in
        if rp is None:
            return False
        items.append((setup, rp))

    # rho digest over the RAW wire bytes (equivalent binding, no re-encode)
    digest = _blob_digest(
        b"bppp batch rlc raw v1", seed, [(c, p) for _, c, p in entries]
    )
    return _merged_zero_check(items, _rhos(len(items), digest), engine)


def _check_subset(collected, rhos, indices, engine) -> bool:
    """One rho-weighted zero-check MSM over an index subset of
    already-collected per-proof pair lists."""
    merged: dict = {}
    for i in indices:
        rho = rhos[i]
        for s, p in collected[i]:
            if p is None:
                continue
            merged[p] = (merged.get(p, 0) + rho * int(s)) % R
    return engine.msm([(s, p) for p, s in merged.items() if s]) is None


def verify_many_encoded(entries, engine=None, seed: bytes = b"") -> list:
    """Per-proof verdicts for a batch of wire-encoded proofs — the
    serving-side counterpart of ``batch_verify_encoded`` (which returns
    one bool for the whole batch).  entries: iterable of
    (setup, coms_bytes, proof_bytes).  Returns list[bool] in input order.

    Strategy: decode everything with ONE batched device sqrt, run ONE
    merged rho-weighted zero check; if it passes, every decodable proof
    is valid (soundness error 1/r per the module docstring).  If it
    fails, bisect: re-check each half's merged MSM, recursing into
    failing halves only — f invalid proofs among n cost O(f log n) extra
    MSMs instead of n, so the common all-valid serving batch stays at
    one MSM.  The rho weights are bound to the raw bytes of the FULL
    batch (undecodable entries included) and are reused unchanged across
    bisection subsets — they remain unpredictable to any prover that
    contributed proofs, which is all the RLC argument needs.
    """
    from .engine import default_engine
    from .range_proof import parse_proof, assemble_proof

    engine = engine or default_engine()
    entries = list(entries)
    n = len(entries)
    if n == 0:
        return []

    results = [False] * n
    decoded = []  # (index, setup, scalars, n_rp, n_in)
    all_xs: list = []
    for i, (setup, coms_bytes, proof_bytes) in enumerate(entries):
        p = parse_proof(setup, coms_bytes, proof_bytes)
        if p is None:
            continue  # undecodable: stays False, never poisons the rest
        scalars, rp_xs, input_xs = p
        decoded.append((i, setup, scalars, len(rp_xs), len(input_xs)))
        all_xs += rp_xs + input_xs

    if not decoded:
        return results
    pts = engine.decompress([x for x, _ in all_xs], [s for _, s in all_xs])

    live = []  # indices (into entries) with structurally valid proofs
    collected = {}  # entry index -> zero-check pairs
    off = 0
    for i, setup, scalars, n_rp, n_in in decoded:
        rp = assemble_proof(
            setup, scalars, pts[off : off + n_rp], pts[off + n_rp : off + n_rp + n_in]
        )
        off += n_rp + n_in
        if rp is None:
            continue
        pairs = collect_pairs(setup, rp)
        if pairs is None:
            continue
        collected[i] = pairs
        live.append(i)
    if not live:
        return results

    digest = _blob_digest(
        b"bppp batch rlc raw v1", seed, [(c, p) for _, c, p in entries]
    )
    rhos = _rhos(n, digest)

    def bisect(idxs):
        if _check_subset(collected, rhos, idxs, engine):
            for i in idxs:
                results[i] = True
            return
        if len(idxs) == 1:
            return  # stays False
        mid = len(idxs) // 2
        bisect(idxs[:mid])
        bisect(idxs[mid:])

    bisect(live)
    return results
