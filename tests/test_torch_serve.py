"""The port's proof service (``bulletproofspp_tpu_torch.serve``): the 12
cases of tests/test_serve.py on the port's HostEngine (every service is
given its engine: the default one is the card's), the repaired faults of
the reference (a collector that dies answers every request it holds or
that is queued, and refuses later ones; the warm set of the CLI's
``serve`` holds every power of two up to the verify fuse cap), the
default engine refusing to run without CUDA, and the CLI's ``serve`` in
a subprocess on the CPU."""

import json
import pathlib
import socket
import subprocess
import sys
import time

import pytest
import torch

from bulletproofspp_tpu.cli import _resolve_values as j_resolve_values
from bulletproofspp_tpu.core import range_proof as jrpm
from bulletproofspp_tpu.core.engine import HostEngine as JHostEngine
from bulletproofspp_tpu.io_ import schema as jschema
from bulletproofspp_tpu_torch import cli
from bulletproofspp_tpu_torch import serve as serve_mod
from bulletproofspp_tpu_torch.cli import _resolve_values
from bulletproofspp_tpu_torch.core import engine as engine_mod
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.batch import verify_many_encoded
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.transcript import take_points
from bulletproofspp_tpu_torch.io_ import schema as schema_mod
from bulletproofspp_tpu_torch.serve import ProofServer, ProofService, _SetupCache, request

REPO = pathlib.Path(__file__).resolve().parent.parent
ENGINE = HostEngine()

SPEC = {
    "basisSeed": "test points",
    "ranges": [{"base": 9, "min": 0, "max": 4294967296, "isOutput": True}],
}
SPEC2 = {
    "basisSeed": "test points 2",
    "ranges": [
        {"base": 9, "min": 0, "max": 4294967296, "isOutput": True},
        {"base": 9, "min": 0, "max": 4294967296, "isOutput": False},
    ],
}


def _mk_encoded(amount, seed, spec_obj=SPEC):
    spec = schema_mod.parse_spec(spec_obj)
    points = take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
    setup = schema_mod.build_setup(spec, points)
    amounts = [{"amount": amount}] * len(spec.ranges)
    values = _resolve_values(spec, schema_mod.parse_witness(amounts))
    proof = rpm.prove(setup, values, seed, ENGINE)
    coms_b, proof_b = rpm.encode_proof(setup, proof)
    return setup, coms_b, proof_b


def test_verify_many_per_proof_verdicts():
    """All-valid batch: one merged MSM, all True.  With invalid proofs
    mixed in (tampered bytes AND undecodable bytes), bisection localizes
    exactly the bad indices without poisoning the rest."""
    entries = [
        _mk_encoded(10_000, b"s1"),
        _mk_encoded(777, b"s2"),
        _mk_encoded(2**31, b"s3"),
        _mk_encoded(42, b"s4"),
    ]
    assert verify_many_encoded(entries, ENGINE) == [True] * 4

    # tamper proof bytes of #1 (stays decodable, fails the zero check);
    # truncate #3 (undecodable)
    s1, c1, p1 = entries[1]
    bad1 = bytearray(p1)
    bad1[-1] ^= 1
    s3, c3, p3 = entries[3]
    mixed = [entries[0], (s1, c1, bytes(bad1)), entries[2], (s3, c3, p3[:7])]
    assert verify_many_encoded(mixed, ENGINE) == [True, False, True, False]

    # duplicate identical proofs must both verify; a bit-flipped twin must not
    dup = [entries[0], entries[0], (s1, c1, bytes(bad1)), entries[1]]
    assert verify_many_encoded(dup, ENGINE) == [True, True, False, True]

    assert verify_many_encoded([], ENGINE) == []


def _talk(port, objs):
    return request("127.0.0.1", port, objs)


def test_server_prove_verify_roundtrip():
    """End-to-end through the TCP transport: pipelined mixed-schema prove
    requests coalesce into batches; returned proofs verify through the
    service and equal the JAX package's for the same seeds; a tampered
    proof answers valid=False; malformed requests answer ok=False without
    harming their batchmates."""
    with ProofServer(engine=ENGINE, linger_ms=50, max_batch=64) as srv:
        proves = [
            {"id": i, "op": "prove", "schema": SPEC if i % 2 == 0 else SPEC2,
             "witness": [{"amount": 100 + i}] * (1 if i % 2 == 0 else 2),
             "seed": bytes([i]).hex()}
            for i in range(5)
        ] + [{"id": 99, "op": "prove", "schema": SPEC, "witness": []}]  # malformed
        resps = _talk(srv.port, proves)
        assert [r["id"] for r in resps] == [0, 1, 2, 3, 4, 99]
        assert all(r["ok"] for r in resps[:5])
        assert resps[5]["ok"] is False and "ranges" in resps[5]["error"]
        for req, resp in zip(proves[:5], resps[:5]):
            jspec = jschema.parse_spec(req["schema"])
            jsetup = jschema.build_setup(
                jspec, take_points(jspec.basis_seed.encode(), jschema.points_needed(jspec)))
            values = j_resolve_values(jspec, jschema.parse_witness(req["witness"]))
            coms_b, proof_b = jrpm.encode_proof(
                jsetup, jrpm.prove(jsetup, values, bytes.fromhex(req["seed"]), JHostEngine()))
            assert (resp["commits"], resp["proof"]) == (coms_b.hex(), proof_b.hex())

        # same seed + same schema => reproducible bytes; no seed => fresh
        again = _talk(srv.port, [dict(proves[0], id=7)])[0]
        assert again["proof"] == resps[0]["proof"]

        verifies = [
            {"id": i, "op": "verify", "schema": SPEC if i % 2 == 0 else SPEC2,
             "commits": r["commits"], "proof": r["proof"]}
            for i, r in enumerate(resps[:5])
        ]
        bad = bytearray(bytes.fromhex(verifies[2]["proof"]))
        bad[-1] ^= 1
        verifies[2]["proof"] = bytes(bad).hex()
        vresps = _talk(srv.port, verifies + [{"op": "stats"}])
        assert [r.get("valid") for r in vresps[:5]] == [True, True, False, True, True]

        stats = vresps[5]
        assert stats["ok"] and stats["requests"] == 12 and stats["proved"] == 6
        # dynamic batching actually happened: fewer batches than requests
        assert stats["batches"] < stats["requests"]
        assert stats["max_batch"] > 1


def test_verify_not_blocked_behind_prove_batch():
    """Batches run on a worker pool: a verify batch submitted while a
    prove batch executes completes without waiting for the proves (no
    head-of-line blocking in the collector)."""
    setup, coms_b, proof_b = _mk_encoded(12345, b"hb")
    svc = ProofService(engine=ENGINE, linger_ms=0, max_batch=8)
    try:
        prove_fut = svc.submit(
            {"op": "prove", "schema": SPEC, "witness": [{"amount": 7}]}
        )
        time.sleep(0.05)  # let the collector hand the prove batch to a worker
        verify_fut = svc.submit(
            {"op": "verify", "schema": SPEC,
             "commits": coms_b.hex(), "proof": proof_b.hex()}
        )
        v = verify_fut.result(timeout=60)
        assert v["ok"] and v["valid"]
        # the slow prove is typically still running when the verify lands;
        # either way it must complete and be valid
        p = prove_fut.result(timeout=120)
        assert p["ok"]
    finally:
        svc.close()


def test_verify_chunked_by_signature_and_pow2():
    """A mixed-schema verify wave larger than max_verify_fuse splits into
    per-signature power-of-two chunks; verdicts stay per request, a
    tampered proof localizes within its chunk, and an undecodable one
    answers False without failing its chunkmates."""
    a = [_mk_encoded(100 + i, bytes([i]), SPEC) for i in range(5)]
    b = [_mk_encoded(200 + i, bytes([64 + i]), SPEC2) for i in range(3)]
    svc = ProofService(engine=ENGINE, linger_ms=0, max_verify_fuse=2)
    try:
        reqs = []
        for i, (_s, c, p) in enumerate(a):
            pb = bytearray(p)
            if i == 3:
                pb[-1] ^= 1  # tampered: decodes, fails the zero check
            reqs.append({"op": "verify", "schema": SPEC,
                         "commits": c.hex(), "proof": bytes(pb).hex()})
        for i, (_s, c, p) in enumerate(b):
            reqs.append({"op": "verify", "schema": SPEC2,
                         "commits": c.hex(),
                         "proof": (p[:9] if i == 1 else p).hex()})  # 1: undecodable
        futs = [svc.submit(r) for r in reqs]
        got = [f.result(timeout=120) for f in futs]
        assert all(r["ok"] for r in got)
        assert [r["valid"] for r in got] == [
            True, True, True, False, True, True, False, True]
    finally:
        svc.close()


def test_batch_runner_failure_resolves_every_future():
    """If a batch runner blows up (or leaves a hole), every Future in the
    batch still resolves with an error — the connection writer waits for
    ALL responses, so an unresolved Future would wedge its connection."""
    svc = ProofService(engine=ENGINE, linger_ms=0)
    try:
        svc._run_batch = lambda batch: (_ for _ in ()).throw(RuntimeError("boom"))
        fut = svc.submit({"op": "prove", "schema": SPEC, "witness": [{"amount": 7}]})
        r = fut.result(timeout=30)
        assert r["ok"] is False and "boom" in r["error"]
    finally:
        svc.close()


def test_max_verify_fuse_validated():
    """max_verify_fuse < 1 is rejected (a 0 cap would spin _chunks_pow2
    forever); a non-pow2 cap floors to a power of two so chunk sizes stay
    within the warmed shape set."""
    with pytest.raises(ValueError):
        ProofService(engine=ENGINE, max_verify_fuse=0)
    svc = ProofService(engine=ENGINE, max_verify_fuse=24)
    try:
        assert svc.max_verify_fuse == 16
    finally:
        svc.close()


def test_invalid_witness_rejected_without_poisoning_batch():
    """An out-of-range witness answers an error at parse time; batchmates
    prove on the fused path (the rendezvous is never poisoned)."""
    with ProofServer(engine=ENGINE, linger_ms=50) as srv:
        out = _talk(srv.port, [
            {"id": 0, "op": "prove", "schema": SPEC, "witness": [{"amount": 7}]},
            {"id": 1, "op": "prove", "schema": SPEC,
             "witness": [{"amount": 2**65}]},  # out of range
            {"id": 2, "op": "prove", "schema": SPEC, "witness": [{"amount": 8}]},
        ])
        assert out[0]["ok"] and out[2]["ok"]
        assert out[1]["ok"] is False and "witness" in out[1]["error"]
        v = _talk(srv.port, [
            {"op": "verify", "schema": SPEC, "commits": r["commits"],
             "proof": r["proof"]}
            for r in (out[0], out[2])
        ])
        assert [r["valid"] for r in v] == [True, True]


def test_warm_compiles_and_stays_out_of_stats():
    """warm() proves/verifies the requested sizes for the schema and does
    not pollute serving stats; a mismatched witness raises."""
    svc = ProofService(engine=ENGINE)
    try:
        svc.warm([(SPEC, [{"amount": 5}])], sizes=(1, 2))
        stats = svc.submit({"op": "stats"}).result(timeout=10)
        assert stats["requests"] == 0 and stats["proved"] == 0
        with pytest.raises(ValueError, match="warm witness"):
            svc.warm([(SPEC, [])], sizes=(1,))
        # warmed schema then serves normally
        r = svc.submit(
            {"op": "prove", "schema": SPEC, "witness": [{"amount": 9}]}
        ).result(timeout=120)
        assert r["ok"]
    finally:
        svc.close()


def test_submit_after_close_resolves():
    """A request submitted after close() must still resolve its Future
    (with an error) — an unresolved Future would block a connection
    writer forever."""
    svc = ProofService(engine=ENGINE)
    svc.close()
    r = svc.submit({"op": "prove", "schema": SPEC, "witness": []}).result(timeout=10)
    assert r["ok"] is False and "closed" in r["error"]


def test_server_unknown_op_and_bad_json():
    with ProofServer(engine=ENGINE) as srv:
        assert _talk(srv.port, [{"op": "nope"}])[0]["ok"] is False
        with socket.create_connection(("127.0.0.1", srv.port)) as sock:
            f = sock.makefile("rwb")
            f.write(b"this is not json\n")
            f.write((json.dumps({"op": "stats"}) + "\n").encode())
            f.flush()
            sock.shutdown(socket.SHUT_WR)
            out = [json.loads(line) for line in f]
        assert out[0]["ok"] is False and "bad request" in out[0]["error"]
        assert out[1]["ok"] is True


def test_server_rejects_oversized_line():
    """A line beyond the bound answers an error and drops the connection
    instead of buffering it into memory."""
    with ProofServer(engine=ENGINE) as srv:
        with socket.create_connection(("127.0.0.1", srv.port)) as sock:
            f = sock.makefile("rwb")
            f.write(b'{"op": "stats", "pad": "' + b"x" * (serve_mod._MAX_LINE + 16) + b'"}\n')
            f.flush()
            sock.shutdown(socket.SHUT_WR)
            out = [json.loads(line) for line in f]
        assert len(out) == 1
        assert out[0]["ok"] is False and "too long" in out[0]["error"]


def test_setup_cache_lru_bounded():
    cache = _SetupCache(max_entries=2)
    specs = [dict(SPEC, basisSeed=f"seed {i}") for i in range(3)]
    a0 = cache.get(specs[0])
    cache.get(specs[1])
    assert cache.get(specs[0]) is a0  # LRU refresh
    cache.get(specs[2])  # evicts specs[1], not specs[0]
    assert len(cache._cache) == 2
    assert cache.get(specs[0]) is a0


def test_collector_death_answers_every_request_over_tcp():
    """If the collector thread fails, the request it held answers ok=false
    over TCP within a bounded time (the reference's would wait forever),
    as do queued and later requests."""
    with ProofServer(engine=ENGINE, linger_ms=0) as srv:
        def boom(batch):
            raise RuntimeError("collector boom")

        srv.service._submit_batch = boom
        with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as sock:
            f = sock.makefile("rwb")
            for i in range(3):
                f.write((json.dumps({"id": i, "op": "prove", "schema": SPEC,
                                     "witness": [{"amount": 7}]}) + "\n").encode())
            f.flush()
            sock.shutdown(socket.SHUT_WR)
            out = [json.loads(line) for line in f]
        assert [r["id"] for r in out] == [0, 1, 2]
        assert all(r["ok"] is False and "collector" in r["error"] for r in out)
        later = srv.service.submit({"op": "verify", "schema": SPEC, "commits": "", "proof": ""})
        r = later.result(timeout=10)
        assert r["ok"] is False and "collector" in r["error"]


def test_serve_warm_set_holds_every_power_of_two_up_to_the_cap():
    """--warm-sizes 16 with --max-verify-fuse 16 warms 1, 2, 4, 8 and 16 (the
    reference tested fuse > max(sizes) and warmed 16 alone)."""
    assert cli.warm_sizes("16", 16) == (1, 2, 4, 8, 16)
    assert cli.warm_sizes("1,2,4,8,16", 16) == (1, 2, 4, 8, 16)
    assert cli.warm_sizes("3,32", 24) == (1, 2, 3, 4, 8, 16, 32)
    assert cli.warm_sizes("", 1) == (1,)


def test_service_default_engine_needs_cuda(monkeypatch):
    monkeypatch.setattr(engine_mod, "_default_engine", None)  # restored after the test
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ProofService()


def test_cli_serve_on_cpu_answers_a_verify():
    """``serve --device cpu`` in a subprocess prints ``serving on host:port``
    once bound and answers a verify request."""
    setup, coms_b, proof_b = _mk_encoded(4242, b"cli")
    proc = subprocess.Popen([sys.executable, "-m", "bulletproofspp_tpu_torch.cli", "serve",
                             "--port", "0", "--device", "cpu"], cwd=REPO,
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on 127.0.0.1:"), line
        port = int(line.strip().rsplit(":", 1)[1])
        [r] = _talk(port, [{"op": "verify", "schema": SPEC, "commits": coms_b.hex(),
                            "proof": proof_b.hex()}])
        assert r == {"ok": True, "valid": True}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
