"""Command-line interface of the PyTorch port: prove / verify / test /
batch-verify / prove-batch / mp-prove / mp-demo / serve.

Usage:
  python -m bulletproofspp_tpu_torch.cli prove  [spec] [witness] [commits] [proof] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli verify [spec] [commits] [proof] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli test   [spec] [witness] [commits] [proof] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli batch-verify spec coms1 proof1 [coms2 proof2 ...] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli prove-batch spec1 wit1 [spec2 wit2 ...] [--out-dir DIR] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli mp-prove [spec] [witness] [commits] [proof] [--parties N] [--local]
      [--party-engine torch|host] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli mp-demo [--parties N] [--values V1,V2,...] [--local] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli serve [--host H] [--port P] [--linger-ms MS] [--max-batch N]
      [--max-verify-fuse N] [--warm SPEC=WITNESS ...] [--warm-sizes 1,2,4,8,16] [--device cuda|cpu]

Defaults mirror the reference (app/Main.hs): schema.json witness.json
commits.bin proof.bin.  ``batch-verify`` decodes N same-schema proofs
(one batched device decompress) and checks them as one merged zero-check
MSM (``core.batch.batch_verify_encoded``); it prints ``Batch of N:
True|False`` and exits 0 or 1.  ``prove-batch`` proves N (spec, witness)
pairs, mixed schemas welcome, through ``core.lockstep.prove_many`` (pair i
with seed ``<randomSeed>#i``) and writes ``commits_i.bin`` and
``proof_i.bin`` into ``--out-dir``.  ``mp-prove`` proves one range proof
with N parties, each holding a contiguous slice of the witness's ranges
(``core/mp_prove.py``): party processes over TCP (``mp-prove-party``), or
threads with ``--local``; it writes the ordinary commits/proof files and
prints ``Multiparty range proof (threads|N TCP subprocesses): True|False``.
The parties run ``TorchEngine`` on ``--device`` unless ``--party-engine
host`` asks for the CPU; threads share the dealer's engine.  ``mp-demo``
runs the aggregated-opening proof of knowledge of ``core/multiparty.py``
over N parties (``mp-party`` processes, or threads with ``--local``).
Exit codes: 0 for a true result, 1 for a false one or a failed party, 2
for a usage error.  ``serve`` runs the proof service
(``serve.py``) until interrupted and prints ``serving on host:port`` once
it is bound.

Installs ``TorchEngine(device)`` as the process's engine and runs the
command on the port's own protocol layer (``core``, ``io_``); an
``mp-prove-party`` with ``--party-engine host`` installs ``HostEngine``
instead and never initializes CUDA.  The
default device is ``cuda``; without CUDA it raises rather than run on the
CPU.  ``--engine`` (host/jax) belongs to the JAX package's CLI and is
refused.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .core import range_proof as rpm
from .core.engine import default_engine, set_default_engine
from .core.fields import Q
from .core.transcript import decode_scalar, default_blinds, encode_scalar, take_points
from .io_ import schema as schema_mod
from .ops.engine import TorchEngine

COMMANDS = ("prove", "verify", "test", "batch-verify", "prove-batch", "mp-demo", "mp-party",
            "mp-prove", "mp-prove-party", "serve")
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_points(spec, count: int):
    if spec.basis_seed is not None:
        return take_points(spec.basis_seed.encode(), count)
    return read_points_file(spec.basis_file)[:count]


def write_points_file(path: str, points):
    """Data.Binary [WideEncoding]: 8-byte big-endian length, then x||y per
    point (reference: app/Main.hs:91-98, 261-263)."""
    with open(path, "wb") as f:
        f.write(len(points).to_bytes(8, "big"))
        for x, y in points:
            f.write(encode_scalar(x))
            f.write(encode_scalar(y))


def read_points_file(path: str):
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "big")
    pts = []
    off = 8
    for _ in range(n):
        x = decode_scalar(data[off : off + 32], Q)
        y = decode_scalar(data[off + 32 : off + 64], Q)
        pts.append((x, y))
        off += 64
    return pts


def _resolve_values(spec, witness_objs):
    """Pair witness amounts with positional default blinds
    (reference: app/Main.hs:272-277)."""
    rn = spec.random_seed.encode()
    gen = default_blinds(rn)
    out = []
    for w in witness_objs:
        bl = next(gen)  # positional: consumed even when an explicit blind exists
        bl = w.blind if w.blind is not None else bl
        if spec.is_binary:
            out.append((w.amount, bl))
        else:
            out.append(((w.amount, w.kind), bl))
    return out


def _verbose_report(setup, proof, level: int, values=None, seed=None, engine=None):
    """Verbose mode (reference: app/Main.hs:214-239, ``runVerbose``):
    structural report + engine metrics, and at level >= 2 a protocol re-run
    printing the per-round ``eval_scalar`` invariant of the collapsing
    argument witness."""
    from . import metrics

    n_rp, nrm_len, lin_len = setup.info()
    print(f"range-proof commitments: {len(proof.rp_coms)} (expected {n_rp})")
    print(f"input commitments:       {len(proof.input_coms)}")
    print(f"argument rounds:         {len(proof.bp.responses)}")
    print(f"witness lengths:         nrm={nrm_len} lin={lin_len}; "
          f"final opening scalars: {len(proof.bp.wit_scalars)}")
    if level >= 2:
        for i, s in enumerate(proof.bp.wit_scalars):
            print(f"  wit[{i}] = {int(s)}")
        if values is not None:
            _verbose_rerun(setup, values, seed, engine)
        snap = metrics.snapshot()
        print(f"engine metrics: {snap['counters']}")


def _verbose_rerun(setup, values, seed, engine):
    """Re-run the prover printing per-round argument invariants: at each
    round the collapsed witness's evaluated scalar (|x|^2_q + <c,l>) next
    to the tracked opening scalar, so a diverging fold shows at the round
    it happens (reference: app/Main.hs:214-239)."""
    from .core import bulletproof
    from .core.transcript import Transcript

    def trace(i, e, sc, arg):
        label = "initial witness" if i < 0 else f"round {i} (e={int(e)})"
        print(f"  {label}: tracked scalar={int(sc)} evalScalar={int(arg.eval_scalar())}")

    wit = setup.witness(values)
    if wit is None:
        return
    bulletproof.set_round_trace(trace)
    try:
        print("verbose protocol re-run:")
        setup.prove(Transcript(seed), engine, values, wit)
    finally:
        bulletproof.set_round_trace(None)


def _batch_verify_cmd(args) -> int:
    """Decode-and-batch-verify same-schema proofs from wire bytes."""
    from .core.batch import batch_verify_encoded

    if len(args.files) % 2 != 0:
        print("batch-verify needs alternating coms/proof file pairs", file=sys.stderr)
        return 2
    engine = default_engine()
    with open(args.spec) as f:
        spec = schema_mod.parse_spec(json.load(f))
    points = load_points(spec, schema_mod.points_needed(spec))
    setup = schema_mod.build_setup(spec, points)
    entries = []
    for i in range(0, len(args.files), 2):
        with open(args.files[i], "rb") as f:
            coms_b = f.read()
        with open(args.files[i + 1], "rb") as f:
            proof_b = f.read()
        entries.append((setup, coms_b, proof_b))
    ok = batch_verify_encoded(entries, engine)
    print(f"Batch of {len(entries)}: {ok}")
    return 0 if ok else 1


def _prove_batch_cmd(args) -> int:
    """Prove N (spec, witness) pairs, mixed schemas welcome, through
    core.lockstep.prove_many (bucketed by fusion signature, one fused
    launch sequence per phase per bucket) and write proof_i.bin /
    commits_i.bin into --out-dir (``bulletproofspp_tpu/cli.py:151-192``)."""
    from .core.lockstep import prove_many

    if len(args.files) % 2 != 0:
        print("prove-batch needs alternating spec/witness file pairs", file=sys.stderr)
        return 2
    engine = default_engine()
    setups = {}  # spec path -> (spec, setup); reuse across repeated specs
    items = []
    for i in range(0, len(args.files), 2):
        spec_path = args.files[i]
        if spec_path not in setups:
            with open(spec_path) as f:
                spec = schema_mod.parse_spec(json.load(f))
            points = load_points(spec, schema_mod.points_needed(spec))
            setups[spec_path] = (spec, schema_mod.build_setup(spec, points))
        spec, setup = setups[spec_path]
        with open(args.files[i + 1]) as f:
            wobjs = schema_mod.parse_witness(json.load(f))
        if len(wobjs) != len(spec.ranges):
            print(f"{args.files[i + 1]}: different number of values and ranges", file=sys.stderr)
            return 2
        values = _resolve_values(spec, wobjs)
        items.append((setup, values, f"{spec.random_seed}#{i // 2}".encode()))
    try:
        proofs = prove_many(items, engine)
    except ValueError as e:
        print(f"prove-batch failed: {e}", file=sys.stderr)
        return 2
    os.makedirs(args.out_dir, exist_ok=True)
    for i, ((setup, _v, _s), proof) in enumerate(zip(items, proofs)):
        coms_bytes, proof_bytes = rpm.encode_proof(setup, proof)
        with open(os.path.join(args.out_dir, f"commits_{i}.bin"), "wb") as f:
            f.write(coms_bytes)
        with open(os.path.join(args.out_dir, f"proof_{i}.bin"), "wb") as f:
            f.write(proof_bytes)
    print(f"Wrote {len(proofs)} proofs to {args.out_dir}")
    return 0


def _party_env() -> dict:
    """The environment of a party process: this one's, with the port's root
    first on PYTHONPATH so ``-m bulletproofspp_tpu_torch.cli`` resolves
    from any working directory."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=os.pathsep.join([PKG_ROOT, path] if path else [PKG_ROOT]))


def _party_cmd(*args) -> list:
    return [sys.executable, "-m", "bulletproofspp_tpu_torch.cli", *(str(a) for a in args)]


def _mp_party_cmd(args) -> int:
    """Internal: one party process of mp-demo (spawned over TCP)."""
    from .core.multiparty import SocketChannel, run_party_share
    from .core.transcript import hash_to_scalar

    ch = SocketChannel.connect(args.host, args.port)
    try:
        blind = hash_to_scalar(b"mp demo blind", bytes([args.index]))
        run_party_share(ch, args.value, blind, seed=bytes([args.index]))
    finally:
        ch.close()
    return 0


def _mp_demo_cmd(args) -> int:
    """Multiparty aggregated-opening proof of knowledge, end to end
    (``bulletproofspp_tpu/cli.py:217-287``): N parties (TCP subprocesses, or
    threads with --local) each commit a secret Pedersen opening; the dealer
    aggregates in the group, broadcasts the Fiat-Shamir challenge, sums the
    response shares, and checks the Schnorr equation on the aggregates."""
    import subprocess
    import threading

    from .core.multiparty import (
        LocalChannel,
        SocketDealerChannel,
        dealer_aggregated_opening,
        make_dealer_listener,
        run_party_share,
    )
    from .core.transcript import Transcript, hash_to_scalar

    n = args.parties
    values = [int(v) for v in args.values.split(",")] if args.values else [101 + i for i in range(n)]
    if len(values) != n:
        print("need exactly --parties values", file=sys.stderr)
        return 2

    if args.local:
        chans = [LocalChannel() for _ in range(n)]
        threads = [
            threading.Thread(target=run_party_share,
                             args=(chans[i], values[i], hash_to_scalar(b"mp demo blind", bytes([i])),
                                   bytes([i])))
            for i in range(n)
        ]
        for t in threads:
            t.start()
        ok, c_agg = dealer_aggregated_opening(chans, Transcript(None))
        for t in threads:
            t.join()
    else:
        listener, port = make_dealer_listener()
        procs = [subprocess.Popen(_party_cmd("mp-party", "127.0.0.1", port, values[i], i,
                                             "--device", args.device), env=_party_env())
                 for i in range(n)]
        chans = []
        try:
            for _ in range(n):
                sock, _ = listener.accept()
                chans.append(SocketDealerChannel(sock))
            ok, c_agg = dealer_aggregated_opening(chans, Transcript(None))
        finally:
            for c in chans:
                c.close()
            listener.close()
            for p in procs:
                p.wait(timeout=30)

    mode = "threads" if args.local else f"{n} TCP subprocesses"
    print(f"Aggregate commitment x: {c_agg[0]:064x}")
    print(f"Multiparty opening proof ({mode}): {ok}")
    return 0 if ok else 1


def mp_partition(n_ranges: int, n_parties: int):
    """Contiguous near-even split of range indices across parties."""
    base, rem = divmod(n_ranges, n_parties)
    out, s = [], 0
    for i in range(n_parties):
        ln = base + (1 if i < rem else 0)
        out.append(list(range(s, s + ln)))
        s += ln
    return out


def _mp_prove_load(spec_path, witness_path):
    with open(spec_path) as f:
        spec = schema_mod.parse_spec(json.load(f))
    with open(witness_path) as f:
        wobjs = schema_mod.parse_witness(json.load(f))
    if len(wobjs) != len(spec.ranges):
        # usage error: exit 2, consistent with prove-batch / --parties
        print("Different number of values and ranges", file=sys.stderr)
        raise SystemExit(2)
    values = _resolve_values(spec, wobjs)
    points = load_points(spec, schema_mod.points_needed(spec))
    setup = schema_mod.build_setup(spec, points)
    return spec, setup, values


def _mp_prove_party_cmd(args) -> int:
    """Internal: one party process of mp-prove (spawned over TCP), on the
    process's engine (``main``: TorchEngine on --device, or HostEngine for
    --party-engine host).

    Demo convenience: parties read the shared witness file and keep only
    their own slice; in a real deployment each party holds only its own
    values and the shared public schema."""
    from .core.mp_prove import party_prove
    from .core.multiparty import SocketChannel

    _spec, setup, values = _mp_prove_load(args.spec, args.witness)
    part = mp_partition(len(values), args.parties)[args.index]
    owned = {i: values[i] for i in part}
    # party-PRIVATE randomness: never derived from the (public) schema — a
    # schema-derived seed would let anyone recompute the blinding and unmask
    # this party's witness from the wire commitments
    seed = os.urandom(32)
    ch = SocketChannel.connect(args.host, args.port)
    try:
        party_prove(setup, ch, owned, seed, default_engine())
    finally:
        ch.close()
    return 0


def mp_prove_local(setup, values, seeds, engine, party_eng, channels=None, timeout=600):
    """The dealer on ``engine`` and ``len(seeds)`` parties on ``party_eng``,
    each on a thread, over in-process channels (``LocalChannel``s, or
    ``channels``): party k owns the k-th slice of ``mp_partition`` and
    draws its randomness from ``seeds[k]``.  Returns the proof; raises
    RuntimeError naming the first party or the dealer that failed, or the
    timeout."""
    import threading
    import time

    from .core.mp_prove import dealer_prove, party_prove
    from .core.multiparty import LocalChannel

    parts = mp_partition(len(values), len(seeds))
    chans = channels or [LocalChannel() for _ in parts]
    errors = []
    result = {}

    def party_work(i):
        try:
            party_prove(setup, chans[i], {j: values[j] for j in parts[i]}, seeds[i], party_eng)
        except Exception as exc:  # reported by the waiting thread below
            errors.append((f"party {i}", exc))

    def dealer_work():
        try:
            result["proof"] = dealer_prove(setup, chans, engine)
        except Exception as exc:  # reported by the waiting thread below
            errors.append(("dealer", exc))

    # the dealer on a thread of its own: if a party dies, dealer_prove would
    # block on its channel forever, so the party's error is reported the
    # moment it lands instead
    threads = [threading.Thread(target=party_work, args=(i,), daemon=True)
               for i in range(len(parts))]
    threads.append(threading.Thread(target=dealer_work, daemon=True))
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not result and not errors:
        threads[-1].join(0.05)
    if "proof" not in result:
        who, exc = errors[0] if errors else ("dealer", f"timed out after {timeout} s")
        raise RuntimeError(f"multiparty {who} failed: {exc}")
    return result["proof"]


def _mp_prove_tcp(args, setup, n, engine):
    """The dealer here and N ``mp-prove-party`` processes over TCP; the
    proof, or None after printing what failed."""
    import socket
    import subprocess
    import time

    from . import native
    from .core.mp_prove import dealer_prove
    from .core.multiparty import SocketDealerChannel, make_dealer_listener
    from .ops import kernels

    # build what the parties load before N processes start at once (each
    # would otherwise run nvcc and g++ itself on a clean tree)
    native.get_lib()
    if args.party_engine == "torch" and torch.device(args.device).type == "cuda":
        kernels.build()
    listener, port = make_dealer_listener()
    listener.settimeout(5.0)
    procs = [
        subprocess.Popen(_party_cmd("mp-prove-party", "127.0.0.1", port, args.spec, args.witness,
                                    i, n, "--device", args.device,
                                    "--party-engine", args.party_engine), env=_party_env())
        for i in range(n)
    ]
    chans = []
    try:
        deadline = time.monotonic() + 300
        while len(chans) < n:
            dead = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if dead:
                raise RuntimeError(f"party {dead[0]} exited rc={procs[dead[0]].returncode} "
                                   "before connecting")
            if time.monotonic() > deadline:
                raise RuntimeError(f"timed out waiting for party connections "
                                   f"({len(chans)}/{n} connected)")
            try:
                sock, _ = listener.accept()
            except socket.timeout:
                continue
            chans.append(SocketDealerChannel(sock))
        proof = dealer_prove(setup, chans, engine)
    except (RuntimeError, ConnectionError, ValueError) as exc:
        # a party crashed or disconnected mid-protocol: its own traceback is
        # on stderr; report and exit cleanly
        print(f"multiparty run failed: {exc}", file=sys.stderr)
        return None
    finally:
        # closing the channels ends the parties still waiting on the dealer;
        # the one that failed finishes writing its traceback before it is
        # waited for (killing it at once could cut its error short)
        for c in chans:
            c.close()
        listener.close()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    if bad:
        print(f"party {bad[0][0]} exited with rc={bad[0][1]}", file=sys.stderr)
        return None
    return proof


def _mp_prove_cmd(args) -> int:
    """Full multiparty range proving (``bulletproofspp_tpu/cli.py:324-486``):
    N parties each hold a disjoint slice of the aggregated schema's ranges
    and jointly produce ONE standard proof (core/mp_prove.py); the dealer
    writes the ordinary commits/proof files and verifies them with the plain
    verifier."""
    from .core.engine import HostEngine

    _spec, setup, values = _mp_prove_load(args.spec, args.witness)
    n = args.parties
    if not (1 <= n <= len(values)):
        print("--parties must be between 1 and the number of ranges", file=sys.stderr)
        return 2
    engine = default_engine()
    if args.local:
        party_eng = HostEngine() if args.party_engine == "host" else engine
        # party-PRIVATE randomness, as in mp-prove-party
        try:
            proof = mp_prove_local(setup, values, [os.urandom(32) for _ in range(n)], engine,
                                   party_eng)
        except RuntimeError as exc:
            print(exc, file=sys.stderr)
            return 1
    else:
        proof = _mp_prove_tcp(args, setup, n, engine)
        if proof is None:
            return 1

    ok = rpm.verify(setup, proof, engine)
    coms_bytes, proof_bytes = rpm.encode_proof(setup, proof)
    with open(args.coms, "wb") as f:
        f.write(coms_bytes)
    with open(args.proof, "wb") as f:
        f.write(proof_bytes)
    mode = "threads" if args.local else f"{n} TCP subprocesses"
    print(f"Wrote {args.proof} ({len(proof_bytes)} bytes), {args.coms} ({len(coms_bytes)} bytes)")
    print(f"Multiparty range proof ({mode}): {ok}")
    return 0 if ok else 1


def warm_sizes(sizes: str, max_verify_fuse: int) -> tuple:
    """The batch sizes ``serve`` warms: those of ``--warm-sizes`` (comma
    separated), and every power of two up to ``max_verify_fuse`` floored to
    one that is not among them (the verify chunk sizes live traffic can
    emit)."""
    out = {int(s) for s in sizes.split(",") if s}
    fuse_pow2 = 1 << (max_verify_fuse.bit_length() - 1)
    return tuple(sorted(out | {1 << k for k in range(fuse_pow2.bit_length())}))


def _serve_cmd(args) -> int:
    """Run the dynamic-batching proof service until interrupted."""
    import threading

    from .serve import ProofServer

    warm_pairs = []
    for item in args.warm:
        spec_path, _, wit_path = item.partition("=")
        if not wit_path:
            print("--warm needs SPEC.json=WITNESS.json", file=sys.stderr)
            return 2
        with open(spec_path) as f:
            schema_obj = json.load(f)
        with open(wit_path) as f:
            witness_list = json.load(f)
        warm_pairs.append((schema_obj, witness_list))
    if args.max_verify_fuse < 1:
        print("--max-verify-fuse must be >= 1", file=sys.stderr)
        return 2
    sizes = warm_sizes(args.warm_sizes, args.max_verify_fuse)
    with ProofServer(args.host, args.port, linger_ms=args.linger_ms, max_batch=args.max_batch,
                     max_verify_fuse=args.max_verify_fuse) as srv:
        if warm_pairs:
            print(f"warming {len(warm_pairs)} schema(s) at sizes {sizes}...", flush=True)
            srv.service.warm(warm_pairs, sizes)
        print(f"serving on {args.host}:{srv.port}", flush=True)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
    return 0


def _parser():
    ap = argparse.ArgumentParser(prog="bulletproofspp-tpu-torch",
                                 description="Prove and Verify Bulletproof++ Zero Knowledge Proofs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, with_wit in [("prove", True), ("verify", False), ("test", True)]:
        p = sub.add_parser(name)
        p.add_argument("spec", nargs="?", default="schema.json")
        if with_wit:
            p.add_argument("witness", nargs="?", default="witness.json")
        p.add_argument("coms", nargs="?", default="commits.bin")
        p.add_argument("proof", nargs="?", default="proof.bin")
        p.add_argument("--verbosity", type=int, default=0)
        p.add_argument("--write-points", type=int, default=0)
    bp = sub.add_parser("batch-verify", help="verify N same-schema proofs as one merged MSM")
    bp.add_argument("spec")
    bp.add_argument("files", nargs="+", help="alternating coms/proof file pairs")
    pb = sub.add_parser("prove-batch",
                        help="prove N (possibly mixed-schema) proofs, bucketed-lockstep fused")
    pb.add_argument("files", nargs="+", help="alternating spec/witness file pairs")
    pb.add_argument("--out-dir", default=".")
    md = sub.add_parser("mp-demo", help="multiparty aggregated-opening proof across N parties "
                        "(TCP subprocesses, or threads with --local)")
    md.add_argument("--parties", type=int, default=3)
    md.add_argument("--values", default=None,
                    help="comma-separated party values (default 101,102,...)")
    md.add_argument("--local", action="store_true",
                    help="in-process threads instead of TCP subprocesses")
    mp = sub.add_parser("mp-party")  # internal: spawned by mp-demo
    mp.add_argument("host")
    mp.add_argument("port", type=int)
    mp.add_argument("value", type=int)
    mp.add_argument("index", type=int)
    mr = sub.add_parser("mp-prove", help="multiparty range proving: N parties each hold a "
                        "disjoint slice of the schema's ranges and jointly produce ONE standard "
                        "proof through the dealer protocol (core/mp_prove.py)")
    mr.add_argument("spec", nargs="?", default="schema.json")
    mr.add_argument("witness", nargs="?", default="witness.json")
    mr.add_argument("coms", nargs="?", default="commits.bin")
    mr.add_argument("proof", nargs="?", default="proof.bin")
    mr.add_argument("--parties", type=int, default=2)
    mr.add_argument("--local", action="store_true",
                    help="in-process threads instead of TCP subprocesses")
    mr.add_argument("--party-engine", choices=["torch", "host"], default="torch",
                    help="the parties' engine: TorchEngine on --device (default; threads share "
                    "the dealer's), or HostEngine on the CPU")
    mrp = sub.add_parser("mp-prove-party")  # internal: spawned by mp-prove
    mrp.add_argument("host")
    mrp.add_argument("port", type=int)
    mrp.add_argument("spec")
    mrp.add_argument("witness")
    mrp.add_argument("index", type=int)
    mrp.add_argument("parties", type=int)
    mrp.add_argument("--party-engine", choices=["torch", "host"], default="torch")
    sv = sub.add_parser("serve", help="proof service: TCP newline-JSON server that batches "
                        "concurrent prove requests into lockstep groups and verify requests "
                        "into merged zero-check MSMs (serve.py)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0)
    sv.add_argument("--linger-ms", type=float, default=5.0)
    sv.add_argument("--max-batch", type=int, default=64)
    sv.add_argument("--max-verify-fuse", type=int, default=16,
                    help="verify chunk cap (per-signature power-of-two chunks)")
    sv.add_argument("--warm", action="append", default=[], metavar="SPEC.json=WITNESS.json",
                    help="run the fused shapes of this schema before serving (repeatable; "
                    "needs a valid witness)")
    sv.add_argument("--warm-sizes", default="1,2,4,8,16",
                    help="comma-separated lockstep batch sizes to warm; every power of two up "
                    "to --max-verify-fuse is added")
    return ap


def _run(args) -> int:
    if args.cmd == "batch-verify":
        return _batch_verify_cmd(args)
    if args.cmd == "prove-batch":
        return _prove_batch_cmd(args)
    if args.cmd == "mp-demo":
        return _mp_demo_cmd(args)
    if args.cmd == "mp-party":
        return _mp_party_cmd(args)
    if args.cmd == "mp-prove":
        return _mp_prove_cmd(args)
    if args.cmd == "mp-prove-party":
        return _mp_prove_party_cmd(args)
    if args.cmd == "serve":
        return _serve_cmd(args)
    with open(args.spec) as f:
        spec = schema_mod.parse_spec(json.load(f))
    engine = default_engine()

    points = load_points(spec, schema_mod.points_needed(spec))
    if args.write_points and spec.basis_seed is not None:
        write_points_file("points.bin", points[: args.write_points])
    setup = schema_mod.build_setup(spec, points)

    to_prove = args.cmd in ("prove", "test")
    to_verify = args.cmd in ("verify", "test")
    rc = 0

    if to_prove:
        with open(args.witness) as f:
            wobjs = schema_mod.parse_witness(json.load(f))
        if len(wobjs) != len(spec.ranges):
            print("Different number of values and ranges", file=sys.stderr)
            return 2
        values = _resolve_values(spec, wobjs)
        try:
            proof = rpm.prove(setup, values, spec.random_seed.encode(), engine)
        except ValueError as e:
            # out-of-range amounts or violated conservation (the reference
            # panics with a message here, app/Main.hs:155-169)
            print(f"prove failed: {e}", file=sys.stderr)
            return 2
        if args.verbosity >= 1:
            _verbose_report(setup, proof, args.verbosity, values, spec.random_seed.encode(), engine)
        if to_verify:
            ok = rpm.verify(setup, proof, engine)
            print(f"In-process verify: {ok}")
            rc |= 0 if ok else 1
        coms_bytes, proof_bytes = rpm.encode_proof(setup, proof)
        with open(args.coms, "wb") as f:
            f.write(coms_bytes)
        with open(args.proof, "wb") as f:
            f.write(proof_bytes)
        print(f"Wrote {args.proof} ({len(proof_bytes)} bytes), {args.coms} ({len(coms_bytes)} bytes)")

    if to_verify:
        with open(args.coms, "rb") as f:
            coms_bytes = f.read()
        with open(args.proof, "rb") as f:
            proof_bytes = f.read()
        dec = rpm.decode_proof(setup, coms_bytes, proof_bytes)
        if dec is None:
            print("invalid proof file", file=sys.stderr)
            return 2
        if args.verbosity >= 1:
            # the reference's verbose mode covers verification too
            # (app/Main.hs:214-239): structural report of the decoded proof
            _verbose_report(setup, dec, args.verbosity)
        ok = rpm.verify(setup, dec, engine)
        print(f"Proof from file: {ok}")
        rc |= 0 if ok else 1
    return rc


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="bulletproofspp-tpu-torch", add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", default=None)
    opts, rest = ap.parse_known_args(argv)
    if opts.engine is not None:
        ap.error("--engine is the JAX package's option; this CLI takes --device")
    if not rest or rest[0] not in COMMANDS:
        ap.error(f"command must be one of {', '.join(COMMANDS)}")
    args = _parser().parse_args(rest)
    args.device = opts.device
    if args.cmd == "mp-prove-party" and args.party_engine == "host":
        from .core.engine import HostEngine

        # the caller asked for the CPU: this process never initializes CUDA
        set_default_engine(HostEngine())
        return _run(args)
    if torch.device(opts.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    set_default_engine(TorchEngine(opts.device))
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
