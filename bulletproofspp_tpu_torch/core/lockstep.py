"""Lockstep batch prover: N same-schema proofs, one device launch sequence
per protocol phase for all of them.

The port's copy of ``bulletproofspp_tpu/core/lockstep.py``; the logic is
the same, line for line.  The per-phase commitment structure of both range
proofs (reference: src/RangeProof/TypedReciprocal.hs:399-444,
Binary.hs:171-204) makes this legal: every prover of the same schema makes
an IDENTICAL sequence of engine calls (phase commitments, then one L/R pair
per round), differing only in scalars.  ``LockstepEngine`` runs N provers
on N threads and rendezvous-batches each synchronizing engine call into
one fused ``msm_many`` on the inner engine, so the card's launches and the
device-to-host copy that ends each MSM are paid once per phase for the
whole batch instead of once per proof.  Per-round basis folds rendezvous
too (``fold_bv_many``: one table_flat launch a basis and one batched fold
launch for all N provers, ``ops/kernels.py: fold_many``): although a fold
never synchronizes, N separate folds are N times the launches, each
latency-bound on a few SMs.

Proof bytes are identical to individually-proven proofs (each thread has
its own transcript; only the launches are fused), as
tests/test_torch_lockstep.py holds.

``prove_many`` is the mixed-schema serving entry: it buckets arbitrary
(setup, values, seed) items by ``fusion_signature`` (the structural key
under which call sequences coincide), locksteps each bucket, and
pipelines buckets across threads, so heterogeneous workloads get
lockstep throughput instead of falling back to per-thread proving.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor


class _Rendezvous:
    """Collects one call per participant, executes the merged batch once,
    and hands each participant its slice.  Errors poison the barrier so
    no thread blocks forever."""

    def __init__(self, n: int):
        self.n = n
        self._cv = threading.Condition()
        self._pending: dict = {}  # method -> list[args]
        self._gen: dict = {}  # method -> int
        self._results: dict = {}  # (method, gen) -> (list | None, error, consumed)
        self._error: BaseException | None = None

    def run(self, method: str, args, exec_all):
        with self._cv:
            if self._error is not None:
                raise self._error
            gen = self._gen.get(method, 0)
            pending = self._pending.setdefault(method, [])
            my = len(pending)
            pending.append(args)
            key = (method, gen)
            if my == self.n - 1:
                self._pending[method] = []
                self._gen[method] = gen + 1
                try:
                    results = exec_all(pending)
                    self._results[key] = [results, None, 0]
                except BaseException as e:  # poison this batch
                    self._results[key] = [None, e, 0]
                self._cv.notify_all()
            else:
                while key not in self._results and self._error is None:
                    self._cv.wait()
                if key not in self._results:
                    raise self._error
            slot = self._results[key]
            slot[2] += 1
            if slot[2] == self.n:
                del self._results[key]
            if slot[1] is not None:
                raise slot[1]
            return slot[0][my]

    def poison(self, err: BaseException):
        """Called when a participant dies outside a rendezvous: every
        waiting and future participant fails fast instead of blocking on
        a barrier that can never fill (a single failure aborts the whole
        lockstep batch anyway)."""
        with self._cv:
            self._error = err
            self._cv.notify_all()


class LockstepEngine:
    """Engine wrapper for N lockstep provers.  Synchronizing methods
    (msm_groups / msm_pair / msm_many) rendezvous and fuse; everything
    else delegates to the inner engine per-proof."""

    def __init__(self, inner, n: int):
        self.inner = inner
        self.n = n
        self._rv = _Rendezvous(n)

    # --- synchronizing (fused) calls -------------------------------------
    def msm_groups(self, groups):
        return self._rv.run("msm_groups", groups, lambda all_: self.inner.msm_many(all_))

    def msm_pair(self, groups_a, groups_b):
        def exec_all(pending):
            flat = [g for ga, gb in pending for g in (ga, gb)]
            outs = self.inner.msm_many(flat)
            return [(outs[2 * i], outs[2 * i + 1]) for i in range(len(pending))]

        return self._rv.run("msm_pair", (groups_a, groups_b), exec_all)

    def msm_many(self, groups_list):
        def exec_all(pending):
            flat = [g for gl in pending for g in gl]
            outs = self.inner.msm_many(flat)
            res, off = [], 0
            for gl in pending:
                res.append(outs[off : off + len(gl)])
                off += len(gl)
            return res

        return self._rv.run("msm_many", list(groups_list), exec_all)

    def fold_bv(self, b, a, even, odd):
        """Per-round basis folds also rendezvous: N separate folds cost N
        launches even though they never sync; one batched fold replaces
        them (inner.fold_bv_many)."""

        def exec_all(pending):
            many = getattr(self.inner, "fold_bv_many", None)
            if many is not None:
                return many(pending)
            return [self.inner.fold_bv(*call) for call in pending]

        return self._rv.run("fold_bv", (b, a, even, odd), exec_all)

    def complete_square(self, r, g0s, g1s):
        """IP-argument square completion (once per proof at argument
        setup) fuses the same way as the folds."""

        def exec_all(pending):
            many = getattr(self.inner, "complete_square_many", None)
            if many is not None:
                return many(pending)
            return [self.inner.complete_square(*call) for call in pending]

        return self._rv.run("complete_square", (r, g0s, g1s), exec_all)

    # --- pass-through ------------------------------------------------------
    def __getattr__(self, name):
        return getattr(self.inner, name)


def prove_lockstep(setup, values_seeds, engine):
    """Prove len(values_seeds) same-schema proofs in lockstep.

    values_seeds: list of (values, random_seed) pairs.  Returns the list
    of RangeProofs (byte-identical to sequential proofs)."""
    n = len(values_seeds)
    if n == 0:
        return []
    return _prove_chunk([(setup, v, s) for v, s in values_seeds], engine)


def _prove_chunk(chunk, engine):
    """One lockstep rendezvous over per-item (setup, values, seed)
    triples whose setups all share a fusion signature."""
    from . import range_proof as rpm

    n = len(chunk)
    if n == 1:
        setup, values, seed = chunk[0]
        return [rpm.prove(setup, values, seed, engine)]
    eng = LockstepEngine(engine, n)

    def one(item):
        setup, values, seed = item
        try:
            return rpm.prove(setup, values, seed, eng)
        except BaseException as e:
            eng._rv.poison(e)
            raise

    with ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(one, chunk))


def fusion_signature(setup):
    """Structural grouping key for ``prove_many``: two setups with equal
    signatures make IDENTICAL engine-call sequences (same methods, same
    shapes, in the same order) during prove — only the points and
    scalars differ — so their provers may legally share one lockstep
    rendezvous.  The call sequence is fully determined by the setup
    class, the argument system, the witness-vector lengths, and the
    digit-decomposition structure (reference:
    src/RangeProof/TypedReciprocal.hs:399-444, Binary.hs:171-204:
    per-phase commitments then one L/R pair per halving round); the
    basis POINTS never affect shapes and are excluded, so same-schema
    setups over different basis seeds fuse too."""
    t = type(setup).__name__
    if t == "SetupTRRP":
        return (
            t,
            setup.arg_cls.__name__,
            setup.has_types,
            tuple(setup.m_bases),
            tuple(setup.sorted_bases),
            setup.nrm_len,
            setup.lin_len,
            repr(setup.rds),
        )
    if t == "SetupBRP":
        return (t, setup.arg_cls.__name__, setup.nrm_len, setup.cons, repr(setup.rds))
    # unknown setup types never fuse with anything (always sound)
    return (t, id(setup))


def _chunks_pow2(seq, cap: int):
    """Split into power-of-two-sized chunks (largest first, each <= cap).

    The fused launches (msm_many / fold_bv_many / ...) take their shapes
    from the batch size N; restricting N to powers of two bounds the set
    of distinct launch shapes a serving workload can trigger to
    log2(cap) + 1 per schema instead of one per request-batch size (the
    shapes the proof service warms)."""
    out, i, n = [], 0, len(seq)
    while i < n:
        size = min(cap, 1 << ((n - i).bit_length() - 1))
        out.append(seq[i : i + size])
        i += size
    return out


def run_chunks(chunks, fn, max_concurrent: int = 4):
    """Run ``fn`` over each chunk, overlapping chunks on up to
    ``max_concurrent`` threads (one chunk's host-side work runs while
    another's launches are in flight).  The ONE implementation of
    the chunk-overlap policy — shared by ``prove_many`` and the proof
    service's verify path so the two cannot drift."""
    chunks = list(chunks)
    if len(chunks) == 1:
        fn(chunks[0])
    elif chunks:
        with ThreadPoolExecutor(max_workers=min(len(chunks), max_concurrent)) as ex:
            # list() propagates the first chunk failure
            list(ex.map(fn, chunks))


def prove_many(items, engine, max_fuse: int = 16, max_concurrent: int = 4):
    """Prove a MIXED batch: ``items`` is a list of (setup, values, seed)
    triples over arbitrary schemas.  This is the serving entry point:
    items are grouped by ``fusion_signature``, each group is chunked into
    power-of-two lockstep batches, and chunks run concurrently on threads
    so one chunk's host-side transcript work overlaps another's launches
    (cross-group pipelining).

    Returns proofs in input order, byte-identical to sequential proving
    (each prover keeps its own transcript; only the launches are fused)."""
    n = len(items)
    if n == 0:
        return []
    groups: dict = {}
    for i, (setup, _v, _s) in enumerate(items):
        groups.setdefault(fusion_signature(setup), []).append(i)
    chunks = [c for idxs in groups.values() for c in _chunks_pow2(idxs, max_fuse)]
    results = [None] * n

    def run_chunk(idxs):
        proofs = _prove_chunk([items[i] for i in idxs], engine)
        for i, p in zip(idxs, proofs):
            results[i] = p

    run_chunks(chunks, run_chunk, max_concurrent)
    return results
