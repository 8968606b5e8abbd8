"""Dry runs of the sharded MSM: one process over a mesh, and N processes.

    python -m bulletproofspp_tpu_torch.dryrun worker COORD N ID msm [--pairs P] [--seed S] [--device D]
    python -m bulletproofspp_tpu_torch.dryrun worker COORD N ID batch CORPUS [--device D]

The port's counterparts of ``__graft_entry__.py: dryrun_multichip`` and
``dryrun_multiprocess``, with the worker entry point above in place of
``tests/multihost_worker.py``:

  * ``dryrun_multichip(n_devices, device)``: the raw sharded MSM over a
    mesh of n entries in this process, against exact host integers; then
    16 encoded 32-bit proofs, made on ``HostEngine``, batch-verified
    through ``ShardedTorchEngine`` on the same mesh (accepted), and once
    more with one proof's byte flipped (rejected);
  * ``dryrun_multiprocess(n_processes, protocol, device)``: N worker
    processes join a gloo process group (``ops.dist``), one mesh entry
    each (``cuda:r``, or ``cuda:0`` for all on a box with one card), and
    run an MSM through ``ShardedTorchEngine`` over the global mesh at win
    = N (the 'win' axis across the processes) and win = 1 (the 'pts'
    axis across them), against exact host integers; with ``protocol``, a
    corpus of encoded proofs batch-verified the same way, accepted, and
    rejected with one proof's byte flipped.  Every rank must print the
    same results.

Each worker prints one ``RUN {json}`` line a run: its wall seconds, its
kernel launches, the number and seconds of its gathers, and on the card its device seconds under
``torch.profiler`` and its peak device memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

WORKER_TIMEOUT = 900  # seconds a worker may run before it is killed


def msm_case(n: int, seed: int):
    """n (scalar, point) pairs over 64 host multiples k_b G, pair i on
    multiple i mod 64, with numpy-seeded 256-bit scalars, and their exact
    sum (sum_i s_i k_b(i) mod R) G: ([(s, P)], affine point)."""
    from .core import ec
    from .core.fields import R

    rng = np.random.default_rng(seed)
    ks = [int(k) for k in rng.integers(1, 2**62, size=64)]
    base = [ec.scalar_mul(k, ec.G) for k in ks]
    buf = rng.bytes(32 * n)
    scalars = [int.from_bytes(buf[32 * i : 32 * i + 32], "little") % R for i in range(n)]
    sums = [0] * len(ks)
    for i, s in enumerate(scalars):
        sums[i % len(ks)] += s
    want = ec.scalar_mul(sum(k * s for k, s in zip(ks, sums)) % R, ec.G)
    return [(s, base[i % len(ks)]) for i, s in enumerate(scalars)], want


def _example_msm_args(points: int, seed: int, device):
    """The JAX dry run's MSM instance (``__graft_entry__.py:13``): points G,
    2G, 4G, ..., seeded scalars, GLV lanes [P, phi(P)].  Returns the lanes'
    affine points and (16, 1, L) planes with (1, ROWS, L) uint8 digits."""
    from .core import ec
    from .core.fields import R
    from .ops import curve, glv

    rng = random.Random(seed)
    pts, p = [], ec.G
    for _ in range(points):
        pts.append(p)
        p = ec.dbl(p)
    halves, lane_pts = [], []
    for pt in pts:
        halves += glv.split(rng.randrange(R))
        lane_pts += [pt, (ec.BETA * pt[0] % ec.P, pt[1])]
    absd, sgn = (torch.as_tensor(d.astype(np.uint8))[None] for d in glv.recode_batch(halves))
    planes = (c.unsqueeze(1) for c in curve.from_affine_host(lane_pts, device))
    return lane_pts, (*planes, absd, sgn)


def _host_msm_from_digits(lane_pts, digits):
    """Exact host evaluation of sum_i (sum_r d[r, i] 16^(rows-1-r)) P_i."""
    from .core import ec
    from .core.fields import R

    total = None
    for i, p in enumerate(lane_pts):
        if p is None:
            continue
        k = 0
        for d in digits[:, i]:
            k = k * 16 + int(d)
        total = ec.add(total, ec.scalar_mul(k % R, p))
    return total


def _batch_corpus(n: int):
    """n encoded 32-bit proofs made on HostEngine (deterministic):
    (spec object, [(commitment bytes, proof bytes)])."""
    from .cli import _resolve_values
    from .core import range_proof as rpm
    from .core.engine import HostEngine
    from .core.transcript import take_points
    from .io_ import schema as schema_mod

    spec_obj = {
        "basisSeed": "mh batch",
        "argument": "NL",
        "ranges": [{"base": 16, "min": 0, "max": 2**32, "isOutput": True}],
    }
    spec = schema_mod.parse_spec(spec_obj)
    setup = schema_mod.build_setup(
        spec, take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec)))
    eng = HostEngine()
    blobs = []
    for i in range(n):
        vals = _resolve_values(spec, schema_mod.parse_witness([{"amount": 1000 + i}]))
        blobs.append(rpm.encode_proof(setup, rpm.prove(setup, vals, f"mh{i}".encode(), eng)))
    return spec_obj, blobs


def write_corpus(path: str, spec_obj, blobs, bad: int | None = None) -> str:
    """A corpus file for the workers' batch mode: the schema object, the
    encoded proofs and the index of the proof to flip (the middle one by
    default)."""
    bad = len(blobs) // 2 if bad is None else bad
    if not 0 <= bad < len(blobs):
        raise ValueError(f"proof {bad} to flip is not among the {len(blobs)} proofs")
    with open(path, "wb") as f:
        pickle.dump({"spec": spec_obj, "blobs": blobs, "bad": bad}, f)
    return path


def _flipped(entries, bad: int):
    """The entries with one bit of proof ``bad``'s first scalar flipped: the
    bytes still parse, so the rejection comes from the merged zero-check."""
    setup, coms_b, proof_b = entries[bad]
    out = list(entries)
    out[bad] = (setup, coms_b, bytes([proof_b[0] ^ 1]) + proof_b[1:])
    return out


def _verify_corpus(spec_obj, blobs, bad: int, engine):
    """(accepted, rejected) of the honest corpus and of the one with proof
    ``bad`` flipped, batch-verified through ``engine``."""
    from .cli import load_points
    from .core.batch import batch_verify_encoded
    from .io_ import schema as schema_mod

    spec = schema_mod.parse_spec(spec_obj)
    setup = schema_mod.build_setup(spec, load_points(spec, schema_mod.points_needed(spec)))
    entries = [(setup, c, p) for c, p in blobs]
    return batch_verify_encoded(entries, engine), batch_verify_encoded(_flipped(entries, bad),
                                                                       engine)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The raw sharded MSM over a mesh of ``n_devices`` entries of
    ``device`` (``ops.sharded.device_entries``) at win = 2 (1 for an odd
    count), against host integers; then 16 encoded proofs batch-verified
    through ``ShardedTorchEngine`` on the same mesh, accepted, and rejected
    with one proof's byte flipped.  Raises on any disagreement."""
    from .ops import curve, sharded
    from .ops.engine import ShardedTorchEngine

    devices = sharded.device_entries(device, n_devices)
    win = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = sharded.make_mesh(devices, win)
    npts = n_devices // win

    # lanes: a power-of-two shard width on each 'pts' entry
    lanes = max(4 * npts, 8)
    while lanes % npts or (lanes // npts) & (lanes // npts - 1):
        lanes *= 2
    lane_pts, (px, py, pz, absd, sgn) = _example_msm_args(lanes // 2, 11, devices[0])
    absd, sgn = sharded.pad_rows(absd, sgn, win)
    got = curve.to_affine_host(sharded.sharded_msm(mesh, px, py, pz, absd, sgn))
    # sign 1 = a negative digit (glv.recode_signed)
    digits = (absd[0].long() * (1 - 2 * sgn[0].long())).numpy()
    if got != [_host_msm_from_digits(lane_pts, digits)]:
        raise AssertionError("the sharded MSM disagrees with the host result")

    # the protocol leg: the merged zero-check MSM of a batch verify is the
    # path ShardedTorchEngine shards (shard_above=64 puts a few hundred
    # merged pairs on the mesh)
    spec_obj, blobs = _batch_corpus(16)
    engine = ShardedTorchEngine(devices[0], mesh=mesh, shard_above=64)
    accepted, rejected = _verify_corpus(spec_obj, blobs, len(blobs) // 2, engine)
    if accepted is not True:
        raise AssertionError("the honest corpus was rejected")
    if rejected is not False:
        raise AssertionError("the tampered corpus was accepted")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_and_reap(cmds: list, env=None) -> list:
    """Runs one process a command list (rank i runs ``cmds[i]``) and returns
    their (stdout, stderr).  Reaped concurrently (waiting on worker 0 alone
    can deadlock while worker 1 fills its pipe mid-collective).  The first
    worker whose reaper sees a non-zero rc is the first to fail; the
    workers still running then are killed (the others cannot finish
    without it), and an AssertionError names the first failure, then every
    other failed worker, each killed one as killed after it, with each
    one's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
                              text=True) for cmd in cmds]
    outs = [None] * len(procs)
    first, killed = [], set()
    lock = threading.Lock()

    def reap(i):
        try:
            outs[i] = procs[i].communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            procs[i].kill()
            outs[i] = procs[i].communicate(timeout=60)
        if procs[i].returncode == 0:
            return
        with lock:
            if first:
                return
            first.append(i)
            for j, p in enumerate(procs):
                if p.poll() is None:
                    p.kill()
                    killed.add(j)

    threads = [threading.Thread(target=reap, args=(i,)) for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not first:
        return outs
    (i0,) = first

    def entry(i):
        rc = procs[i].returncode
        if i == i0:
            note = " (first to fail)"
        elif i in killed and rc == -signal.SIGKILL:
            note = f" (killed after rank {i0} failed)"
        else:
            note = ""
        return f"rank {i} rc {rc}{note}\n{outs[i][0]}\n{outs[i][1]}"

    others = [i for i, p in enumerate(procs) if p.returncode != 0 and i != i0]
    raise AssertionError("multiprocess worker(s) failed: " + "\n".join(map(entry, [i0, *others])))


def _run_workers(n: int, args: list) -> list:
    """N workers on one process group: [(rank, [RUN records])]; a failure
    raises with every failed worker's output (``_spawn_and_reap``)."""
    from .cli import _party_env

    coord = f"127.0.0.1:{_free_port()}"
    outs = _spawn_and_reap(
        [[sys.executable, "-m", "bulletproofspp_tpu_torch.dryrun", "worker", coord, str(n),
          str(rank), *args] for rank in range(n)], _party_env())
    runs = [[json.loads(line[4:]) for line in out.splitlines() if line.startswith("RUN ")]
            for out, _ in outs]
    if not runs[0] or any([r["result"] for r in rank_runs] != [r["result"] for r in runs[0]]
                          for rank_runs in runs):
        raise AssertionError(f"the ranks' results differ: {runs}")
    return runs


def dryrun_multiprocess(n_processes: int = 2, protocol: bool = True, device: str = "cuda",
                        msm_pairs: int = 64, msm_seed: int = 99, corpus: str | None = None):
    """N worker processes over one gloo process group run ``msm_case(msm_pairs,
    msm_seed)`` through ``ShardedTorchEngine`` on the global mesh at win = N
    and win = 1 (N a power of two), and with ``protocol`` a batch verify of
    ``corpus`` (``write_corpus``; by default 64 HostEngine proofs), accepted,
    and rejected with its flipped proof.  Returns each rank's RUN records:
    [msm records, batch records]."""
    from . import native
    from .ops import kernels

    # build what the workers load before N processes start at once (each
    # would otherwise run nvcc and g++ itself on a clean tree)
    native.get_lib()
    if torch.device(device).type == "cuda":
        kernels.build()
    out = [_run_workers(n_processes, ["msm", "--pairs", str(msm_pairs), "--seed", str(msm_seed),
                                      "--device", device])]
    if protocol:
        with tempfile.TemporaryDirectory(prefix="bppp_dryrun_") as d:
            path = corpus or write_corpus(os.path.join(d, "corpus.pkl"), *_batch_corpus(64))
            out.append(_run_workers(n_processes, ["batch", path, "--device", device]))
    return out


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def measured(record: dict, dev: torch.device):
    """Fills ``record`` with the block's wall seconds, its kernel launches,
    the number and seconds of its gathers and, on the card, its device
    seconds under torch.profiler and its peak device memory."""
    from . import metrics
    from .ops import kernels

    metrics.reset()
    before = kernels.counts()
    with contextlib.ExitStack() as stack:
        prof = None
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize(dev)  # a new process's first CUDA call makes its context
            torch.cuda.reset_peak_memory_stats(dev)
            prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                           ProfilerActivity.CUDA]))
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        record["wall_s"] = time.perf_counter() - t0
    record["launches"] = {k: n - before[k] for k, n in kernels.counts().items() if n > before[k]}
    snap = metrics.snapshot()
    record["gathers"] = snap["counters"].get("dist.all_gather.calls", 0)
    record["gather_s"] = snap["seconds"].get("dist.all_gather", 0.0)
    if prof is not None:
        from .engine_profile import device_time

        record["device_s"], _ = device_time(prof, None)
        record["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30


def _worker(args) -> int:
    from .ops import dist, sharded
    from .ops.engine import ShardedTorchEngine

    os.environ.update(BPPP_COORDINATOR=args.coord, BPPP_NUM_PROCS=str(args.nprocs),
                      BPPP_PROC_ID=str(args.rank))
    if not dist.initialize_from_env():
        raise RuntimeError("the worker did not join the process group")
    try:
        dev = sharded.device_entries(args.device, 1, start=args.rank)[0]
        if args.mode == "msm":
            pairs, want = msm_case(args.pairs, args.seed)
            runs = []
            for win in (args.nprocs, 1):
                eng = ShardedTorchEngine(dev, mesh=dist.global_mesh(win, [dev]), shard_above=0)
                record = {"mode": "msm", "win": win, "pairs": len(pairs), "device": str(dev)}
                with measured(record, dev):
                    got = eng.msm(pairs)
                if got != want:
                    raise AssertionError(f"win={win}: the sharded MSM differs from the host answer")
                record["result"] = [str(got[0]), str(got[1])]
                runs.append(record)
        else:
            with open(args.corpus, "rb") as f:
                corpus = pickle.load(f)  # written by this module's parent process
            eng = ShardedTorchEngine(dev, mesh=dist.global_mesh(args.nprocs, [dev]),
                                     shard_above=64)
            record = {"mode": "batch", "win": args.nprocs, "proofs": len(corpus["blobs"]),
                      "bad": corpus["bad"], "device": str(dev)}
            with measured(record, dev):
                accepted, rejected = _verify_corpus(corpus["spec"], corpus["blobs"],
                                                    corpus["bad"], eng)
            if (accepted, rejected) != (True, False):
                raise AssertionError(f"batch verify: honest {accepted}, tampered {rejected}")
            record["result"] = [accepted, rejected]
            runs = [record]
        for record in runs:
            print("RUN " + json.dumps(record), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bulletproofspp_tpu_torch.dryrun")
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker", help="one rank of dryrun_multiprocess")
    w.add_argument("coord", help="host:port of the process group's rendezvous")
    w.add_argument("nprocs", type=int)
    w.add_argument("rank", type=int)
    modes = w.add_subparsers(dest="mode", required=True)
    m = modes.add_parser("msm")
    m.add_argument("--pairs", type=int, default=64)
    m.add_argument("--seed", type=int, default=99)
    b = modes.add_parser("batch")
    b.add_argument("corpus")
    for p in (m, b):
        p.add_argument("--device", default="cuda")
    return _worker(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
