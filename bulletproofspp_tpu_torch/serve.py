"""Proof service: a TCP server with DYNAMIC BATCHING over the lockstep
prover and the merged batch verifier — the production-serving runtime
the reference's one-proof-per-invocation CLI (reference:
app/Main.hs:143-185) does not have.

The port's copy of ``bulletproofspp_tpu/serve.py``, on the port's
``core.lockstep``, ``core.batch``, ``io_.schema`` and CLI helpers; the
default engine is ``core.engine.default_engine()``, a ``TorchEngine`` on
the CUDA card.  One fault of the reference is repaired: if the collector
thread fails, every queued and held request is answered with an error and
later submits are refused, where the reference's connections would wait
forever.

Why a server: a single proof leaves the card idle most of its time (its
launches are small and its host work serial), and both hot paths are
batch-shaped — ``core.lockstep.prove_many`` fuses N provers into one
launch sequence per protocol phase, and ``core.batch.verify_many_encoded``
verifies N proofs with ONE merged zero-check MSM (bisecting only on
failure).  The service turns INDEPENDENT concurrent requests into those
batches: requests queue, a collector lingers a few milliseconds to let a
batch accumulate, then the whole batch runs fused.  Throughput then
scales with concurrency instead of being capped by per-proof round-trips.

Wire protocol (newline-delimited JSON, one object per line, binary
fields hex-encoded; any client-supplied "id" is echoed back and
responses per connection are written in request order):

  {"op": "prove", "schema": {...}, "witness": [...], "seed": "<hex>"?}
    -> {"ok": true, "commits": "<hex>", "proof": "<hex>"}
  {"op": "verify", "schema": {...}, "commits": "<hex>", "proof": "<hex>"}
    -> {"ok": true, "valid": true|false}
  {"op": "stats"}
    -> {"ok": true, "requests": N, "batches": N, "proved": N,
        "verified": N, "max_batch": N, "parse_s": S, "prove_exec_s": S,
        "verify_exec_s": S, "queue_wait_s": S}
       (the *_s keys are cumulative wall seconds inside the batch
        runners — where a slow service is actually spending its time)

"schema" is the reference's schema.json object (io_/schema.py); setups
are cached by canonical schema JSON so repeated schemas pay parsing and
basis generation once.  "seed" (prover randomness) defaults to fresh
``os.urandom`` per request — two identical requests give two different,
both-valid proofs; pass an explicit seed for reproducible output.
Malformed requests answer {"ok": false, "error": ...} without affecting
other requests in the same batch.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import socketserver
import threading
import time as _time
from concurrent.futures import Future

from .core.engine import default_engine
from .io_ import schema as schema_mod


class _SetupCache:
    """schema dict -> (spec, setup), keyed by canonical JSON.  LRU-capped:
    setups hold basis points and schema structure, so an unauthenticated
    client sending a stream of never-repeating schemas must not grow
    server memory without bound."""

    def __init__(self, max_entries: int = 64):
        from collections import OrderedDict

        self.max_entries = max_entries
        self._cache: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, schema_obj: dict):
        key = json.dumps(schema_obj, sort_keys=True, separators=(",", ":"))
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                return hit
        from .cli import load_points

        spec = schema_mod.parse_spec(schema_obj)
        points = load_points(spec, schema_mod.points_needed(spec))
        setup = schema_mod.build_setup(spec, points)
        with self._lock:
            entry = self._cache.setdefault(key, (spec, setup))
            self._cache.move_to_end(key)
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
            return entry


class ProofService:
    """The batching core, independent of any transport: ``submit`` a
    request dict, get a Future of the response dict.  A single collector
    thread drains the queue (lingering ``linger_ms`` after the first
    arrival so concurrent requests coalesce), then runs all verifies as
    one ``verify_many_encoded`` batch and all proves as one
    ``prove_many`` batch."""

    def __init__(self, engine=None, linger_ms: float = 5.0, max_batch: int = 64,
                 workers: int = 2, max_verify_fuse: int = 16):
        self.engine = engine or default_engine()
        self.linger_ms = linger_ms
        self.max_batch = max_batch
        if max_verify_fuse < 1:
            raise ValueError("max_verify_fuse must be >= 1")
        # floor to a power of two: _chunks_pow2 only emits pow2 sizes, and
        # a non-pow2 cap would let a 24-sized chunk through — an unwarmed
        # launch shape, outside the set warm() covers
        self.max_verify_fuse = 1 << (max_verify_fuse.bit_length() - 1)
        self._setups = _SetupCache()
        self._q: queue.Queue = queue.Queue()
        # *_exec_s are cumulative wall seconds inside the batch runners —
        # served through the stats op so a production operator (or the
        # bench) can see where a slow service is actually spending time
        self._stats = {"requests": 0, "batches": 0, "proved": 0, "verified": 0,
                       "max_batch": 0, "parse_s": 0.0, "prove_exec_s": 0.0,
                       "verify_exec_s": 0.0, "queue_wait_s": 0.0}
        self._stats_lock = threading.Lock()
        self._closed = False
        self._closed_error = "service closed"  # the collector's failure, if it fails
        # batches execute on a small pool, not on the collector itself, so
        # a fast verify batch is not head-of-line blocked behind a slow
        # prove batch and the collector keeps coalescing during execution
        from concurrent.futures import ThreadPoolExecutor

        self._pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)
        self._collector.start()

    def submit(self, request: dict) -> Future:
        fut: Future = Future()
        op = request.get("op")
        if op == "stats":
            with self._stats_lock:
                fut.set_result({"ok": True, **self._stats})
            return fut
        if op not in ("prove", "verify"):
            fut.set_result({"ok": False, "error": f"unknown op: {op!r}"})
            return fut
        if self._closed:
            fut.set_result({"ok": False, "error": self._closed_error})
            return fut
        with self._stats_lock:
            self._stats["requests"] += 1
        self._q.put((request, fut, _monotonic()))
        # close() may have set _closed and run its final drain between
        # the check above and the put — nothing will read the queue then,
        # so resolve the straggler here rather than hang its connection
        if self._closed and not fut.done():
            self._drain_closed()
            if not fut.done():
                fut.set_result({"ok": False, "error": self._closed_error})
        return fut

    def close(self):
        self._closed = True
        self._q.put(None)
        self._collector.join(timeout=30)
        self._pool.shutdown(wait=True)
        self._drain_closed()  # catch submits that raced the sentinel

    def warm(self, pairs, sizes=(1, 2, 4, 8, 16)):
        """Run the fused launch shapes for the given schemas before taking
        traffic.  On the card there is nothing to compile per shape: warm
        builds the kernel libraries (``kernels.lib()``, the nvcc build at
        first use), fills the engine's basis cache and runs each shape once.
        pairs: list of (schema_obj, witness_list) — a valid witness is
        needed because the prover refuses invalid ones before any launch.
        For each schema, proves one batch of every size in ``sizes``
        (lockstep shapes are per power-of-two batch size) and verifies a
        batch of every size too — ``_run_verifies`` chunks live traffic to
        per-signature power-of-two batches, so these are exactly the
        decompress + zero-check shapes it can emit.  Warm work bypasses
        submit() so it never shows up in stats."""
        from .core import range_proof as rpm
        from .core.batch import verify_many_encoded
        from .core.lockstep import prove_many

        device = getattr(self.engine, "device", None)
        if device is not None and device.type == "cuda":
            from .ops import kernels

            kernels.lib()
        for schema_obj, witness_list in pairs:
            spec, setup = self._setups.get(schema_obj)
            wobjs = schema_mod.parse_witness(witness_list)
            if len(wobjs) != len(spec.ranges):
                raise ValueError("warm witness does not match schema ranges")
            from .cli import _resolve_values

            values = _resolve_values(spec, wobjs)
            encoded = []
            for n in sorted(set(sizes)):
                items = [
                    (setup, values, b"warm" + str(i).encode()) for i in range(n)
                ]
                # default max_fuse, matching _run_proves — warming a
                # different chunk size would run the wrong shapes
                proofs = prove_many(items, self.engine)
                if n == max(sizes):
                    encoded = [
                        (setup, *rpm.encode_proof(setup, p)) for p in proofs
                    ]
            for n in sorted(set(sizes)):
                if n <= len(encoded):
                    verify_many_encoded(encoded[:n], self.engine)

    # -- collector ---------------------------------------------------------

    def _collect_loop(self):
        """Drain the queue into batches.  If anything in here raises, the
        collector is gone and nothing would read the queue again: every
        request it holds or that is queued is answered with the error, and
        later submits are refused (a connection's writer waits for every
        response, so one unanswered request would wedge it)."""
        batch = []
        try:
            while True:
                batch = []
                item = self._q.get()
                if item is None:
                    self._drain_closed()
                    return
                batch = [item]
                # linger: let concurrent requests coalesce into this batch
                deadline = _monotonic() + self.linger_ms / 1000.0
                while len(batch) < self.max_batch:
                    timeout = deadline - _monotonic()
                    if timeout <= 0:
                        # drain whatever is already queued, but stop waiting
                        try:
                            nxt = self._q.get_nowait()
                        except queue.Empty:
                            break
                    else:
                        try:
                            nxt = self._q.get(timeout=timeout)
                        except queue.Empty:
                            break
                    if nxt is None:
                        self._submit_batch(batch)
                        self._drain_closed()
                        return
                    batch.append(nxt)
                self._submit_batch(batch)
        except BaseException as e:
            self._closed_error = f"service collector failed: {e!r}"
            self._closed = True
            for _req, fut, _t in batch:
                if not fut.done():
                    fut.set_result({"ok": False, "error": self._closed_error})
            self._drain_closed()
            raise  # the thread's excepthook reports the traceback

    def _submit_batch(self, batch):
        """Hand a batch to the pool; if the pool refuses (shutdown race),
        resolve the batch's futures instead of stranding them — the
        writer waits for every response, so a stranded Future wedges its
        connection."""
        try:
            self._pool.submit(self._run_batch_safe, batch)
        except RuntimeError:
            for item in batch:
                if not item[1].done():
                    item[1].set_result({"ok": False, "error": "service closed"})

    def _drain_closed(self):
        """Fail any request that raced past the _closed check in submit
        after the shutdown sentinel — no Future may be left unresolved
        (a connection writer would block on it forever)."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item[1].done():
                item[1].set_result({"ok": False, "error": self._closed_error})

    def _run_batch_safe(self, batch):
        """Pool entry: NO path may leave a Future unresolved — the
        connection writer blocks in fut.result() and, since it waits for
        every queued response, an unresolved Future would wedge the
        connection forever.  The finally sweep is the hard guarantee
        (it also catches partial-batch holes a runner bug might leave,
        not just exceptions that escape _run_batch)."""
        err = "internal error"
        try:
            self._run_batch(batch)
        except BaseException as e:  # pragma: no cover - defensive
            err = f"internal error: {e}"
        finally:
            for item in batch:  # items are (request, fut, enqueue_time)
                fut = item[1]
                if not fut.done():
                    fut.set_result({"ok": False, "error": err})

    def _run_batch(self, batch):
        t0 = _monotonic()
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["max_batch"] = max(self._stats["max_batch"], len(batch))
            self._stats["queue_wait_s"] += sum(t0 - t for _r, _f, t in batch)
        proves, verifies = [], []
        for req, fut, _t in batch:
            try:
                parsed = self._parse(req)
            except Exception as e:  # malformed request: answer, don't poison
                fut.set_result({"ok": False, "error": str(e)})
                continue
            (proves if req["op"] == "prove" else verifies).append((parsed, fut))
        t1 = _monotonic()
        if verifies:
            self._run_verifies(verifies)
        t2 = _monotonic()
        if proves:
            self._run_proves(proves)
        with self._stats_lock:
            self._stats["parse_s"] += t1 - t0
            self._stats["verify_exec_s"] += t2 - t1
            self._stats["prove_exec_s"] += _monotonic() - t2

    def _parse(self, req):
        spec, setup = self._setups.get(req["schema"])
        if req["op"] == "verify":
            return (setup, bytes.fromhex(req["commits"]), bytes.fromhex(req["proof"]))
        from .cli import _resolve_values

        wobjs = schema_mod.parse_witness(req["witness"])
        if len(wobjs) != len(spec.ranges):
            raise ValueError("different number of values and ranges")
        values = _resolve_values(spec, wobjs)
        # reject invalid witnesses here (cheap host math) rather than let
        # one poison a fused lockstep batch into the sequential fallback
        if setup.witness(values) is None:
            raise ValueError("invalid witness")
        seed = bytes.fromhex(req["seed"]) if "seed" in req else os.urandom(16)
        return (setup, values, seed)

    def _run_verifies(self, verifies):
        """Verify requests run as merged zero-check MSMs — but grouped by
        fusion signature and chunked to power-of-two sizes, mirroring
        ``prove_many``, so that the launch shapes live traffic can emit
        are the ones ``warm`` covers; each chunk is still one merged MSM
        with its own RLC digest, so soundness is unchanged."""
        from .core.batch import verify_many_encoded
        from .core.lockstep import _chunks_pow2, fusion_signature, run_chunks

        groups: dict = {}
        for i, ((setup, _c, _p), _fut) in enumerate(verifies):
            groups.setdefault(fusion_signature(setup), []).append(i)
        chunks = [c for idxs in groups.values()
                  for c in _chunks_pow2(idxs, self.max_verify_fuse)]

        def run_chunk(chunk):
            sub = [verifies[i] for i in chunk]
            try:
                verdicts = verify_many_encoded([p for p, _ in sub], self.engine)
            except Exception as e:  # chunk-level failure stays in-chunk
                for _, fut in sub:
                    fut.set_result({"ok": False, "error": str(e)})
                return
            with self._stats_lock:
                self._stats["verified"] += len(sub)
            for (_, fut), valid in zip(sub, verdicts):
                fut.set_result({"ok": True, "valid": bool(valid)})

        # chunks overlap exactly as prove_many's do (shared policy)
        run_chunks(chunks, run_chunk)

    def _run_proves(self, proves):
        from .core import range_proof as rpm
        from .core.lockstep import prove_many

        try:
            proofs = prove_many([p for p, _ in proves], self.engine)
        except Exception:
            # batch-level failure (e.g. one unprovable witness poisoning a
            # lockstep rendezvous): fall back to sequential so one bad
            # request can't fail its batchmates
            proofs = []
            for (setup, values, seed), _ in proves:
                try:
                    proofs.append(rpm.prove(setup, values, seed, self.engine))
                except Exception as e:
                    proofs.append(e)
        with self._stats_lock:
            self._stats["proved"] += sum(1 for p in proofs if not isinstance(p, Exception))
        for ((setup, _v, _s), fut), proof in zip(proves, proofs):
            if isinstance(proof, Exception):
                fut.set_result({"ok": False, "error": str(proof)})
            else:
                coms_bytes, proof_bytes = rpm.encode_proof(setup, proof)
                fut.set_result(
                    {"ok": True, "commits": coms_bytes.hex(), "proof": proof_bytes.hex()}
                )


def _monotonic():
    return _time.monotonic()


# -- TCP transport ---------------------------------------------------------

_MAX_LINE = 4 << 20  # 4 MiB: > the largest legitimate request (128x64
# aggregated proofs are ~5 KB; schemas are smaller), << a memory hazard


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        service = self.server.service  # type: ignore[attr-defined]
        pending: queue.Queue = queue.Queue()

        def writer():
            while True:
                fut = pending.get()
                if fut is None:
                    return
                fut, req_id = fut
                resp = fut.result()
                if req_id is not None:
                    resp = {"id": req_id, **resp}
                try:
                    self.wfile.write((json.dumps(resp) + "\n").encode())
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        try:
            while True:
                # bounded readline: a client must not be able to buffer an
                # arbitrarily long line into server memory
                line = self.rfile.readline(_MAX_LINE + 1)
                if not line:
                    break
                if len(line) > _MAX_LINE:
                    fut = Future()
                    fut.set_result({"ok": False, "error": "request line too long"})
                    pending.put((fut, None))
                    break  # stream is now mid-line garbage; drop the connection
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                    req_id = req.get("id")
                    fut = service.submit(req)
                except Exception as e:
                    fut = Future()
                    fut.set_result({"ok": False, "error": f"bad request: {e}"})
                    req_id = None
                pending.put((fut, req_id))
        finally:
            pending.put(None)
            # wait for EVERY queued response to be written: futures always
            # resolve (batch runners never leave one pending, and a failed
            # collector answers everything it held or that is queued), but
            # a large batch can hold its responses for seconds, and a
            # bounded join would drop them.  The writer itself exits on
            # client disconnect, so this join cannot hang forever.
            wt.join()


class ProofServer(socketserver.ThreadingTCPServer):
    """``with ProofServer(port=0) as s:`` — serves on a background thread,
    ``s.port`` is the bound port."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0, engine=None,
                 linger_ms: float = 5.0, max_batch: int = 64,
                 max_verify_fuse: int = 16):
        self.service = ProofService(engine, linger_ms=linger_ms,
                                    max_batch=max_batch,
                                    max_verify_fuse=max_verify_fuse)
        super().__init__((host, port), _Handler)
        self.port = self.server_address[1]
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self.shutdown()
        super().server_close()
        self.service.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request(host: str, port: int, objs):
    """Minimal pipelining client: send every request, then read every
    response (in order).  objs: list of request dicts.  Returns the list
    of response dicts."""
    with socket.create_connection((host, port)) as sock:
        f = sock.makefile("rwb")
        for obj in objs:
            f.write((json.dumps(obj) + "\n").encode())
        f.flush()
        sock.shutdown(socket.SHUT_WR)
        return [json.loads(line) for line in f]
