"""Where the time of a prove, a verify and a batch verify goes on the card, by engine call.

    python -m bulletproofspp_tpu_torch.engine_profile [--repeat 2] [--plain fold]
    python -m bulletproofspp_tpu_torch.engine_profile --batch 1024 [--repeat 2]
    python -m bulletproofspp_tpu_torch.engine_profile --lockstep 16
    python -m bulletproofspp_tpu_torch.engine_profile --mp 4

For examples/64bit and examples/128by64: one warm-up prove and verify,
then ``--repeat`` timed runs of each.  Every ``TorchEngine`` call is
wrapped with ``torch.cuda.synchronize()`` on both sides and its seconds
are summed by kind (``msm_many``, ``fold_bv``, ...).  Prove seconds are
those of ``range_proof.prove``; verify seconds those of ``decode_proof``
and ``verify``.  Then one prove and one verify of each run under
``torch.profiler``: the device time of each kernel, their sum, the device
time and launches of each wrapper of ``ops.kernels`` (``by_wrapper``, with
``"library"``: the kernels no wrapper launches, PyTorch's own operators),
the memory copies by kind, ms and count (``copies``: host-to-device,
pinned or pageable, and device-to-host), whether the profile holds every launch of the port's kernels, and the
device's idle share against the wall time of the same call without the
profiler.

``--batch N`` instead proves N distinct proofs of examples/64bit (amount
10^9 + i, seed ``bench<i>``, as the JAX package's ``bench.py`` batch) through the
engine, then times ``core.batch.batch_verify_encoded`` over all of them
(one warm-up, then ``--repeat`` runs): seconds by engine call
(``decompress``, ``msm``), the rest as host seconds (parsing, transcript
replay, merging), the number of decompressed points and the merged MSM's
points and lane bucket.

``--lockstep N`` proves one bucket of N distinct examples/64bit proofs
(amount 10^9 + i, seed ``lockstep<i>``) through ``core.lockstep.prove_many``
and the same N one at a time through ``range_proof.prove``, each once to
warm up, once timed and once under ``torch.profiler``: wall seconds, device
seconds and the device's idle share, device ms and launches by wrapper,
and the fold launches of each route (``fold_many``: one prover a launch
one at a time, all of a lockstep bucket's at once, each building its
tables in its launch; ``fold`` and ``table_flat``, which a fold took two
of before fold_many took the one-prover fold, stay counted);
the two routes' proofs must be equal byte for byte.

``--mp P`` proves examples/128by64 with P parties (contiguous slices of its
ranges, seeds ``mp party <k>``) on threads and the dealer on another, all
on one ``TorchEngine`` (``mp-prove --local``'s route), and the same schema
once by one prover (``range_proof.prove``), each once to warm up, once
timed and once under ``torch.profiler``: wall and device seconds, the
idle share, device ms and launches by wrapper, and the fold, fold_many,
table_flat and select_reduce launches, for the multiparty route split at the moment
the dealer holds every party's final share (before it: the parties'
phase commitments; after it: the dealer's argument rounds).

``--plain NAME`` swaps kernel NAME's wrapper (``ops.kernels``) for its
plain PyTorch version for the whole run (``plain_versions``), to see what
the kernel saves end to end.  Output: the card's ``nvidia-smi`` line,
then one JSON object per run and one per profile.  Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from . import cli
from .core import range_proof as rpm
from .core.batch import batch_verify_encoded
from .core.lockstep import prove_many
from .core.multiparty import LocalChannel
from .io_ import schema as schema_mod
from .ops import kernels
from .ops.engine import TorchEngine, _bucket

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CALLS = ("basevec", "bv_pad", "bv_split", "msm", "msm_many", "fold_bv", "complete_square",
         "decompress")


class TimedEngine(TorchEngine):
    """TorchEngine whose outermost calls are synchronized (on a CUDA device)
    and timed by kind (a call made from inside another, such as msm ->
    msm_many, counts only in the outer one)."""

    def __init__(self, device):
        super().__init__(device)
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.sizes = {}  # kind -> length of the last outer call's first argument
        self._depth = 0

    def reset(self):
        self.seconds.clear()
        self.calls.clear()
        self.sizes.clear()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()


def _timed(name):
    inner = getattr(TorchEngine, name)

    def call(self, *a, **k):
        if self._depth:
            return inner(self, *a, **k)
        if a and isinstance(a[0], (list, tuple)):
            self.sizes[name] = len(a[0])
        self.sync()
        t0 = time.perf_counter()
        self._depth += 1
        try:
            return inner(self, *a, **k)
        finally:
            self._depth -= 1
            self.sync()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    return call


for _name in CALLS:
    setattr(TimedEngine, _name, _timed(_name))


def _load(name):
    d = os.path.join(EXAMPLES, name)
    with open(os.path.join(d, "schema.json")) as f:
        spec = schema_mod.parse_spec(json.load(f))
    setup = schema_mod.build_setup(spec, cli.load_points(spec, schema_mod.points_needed(spec)))
    with open(os.path.join(d, "witness.json")) as f:
        values = cli._resolve_values(spec, schema_mod.parse_witness(json.load(f)))
    return spec, setup, values


def _prove(case, eng):
    spec, setup, values = case
    proof = rpm.prove(setup, values, spec.random_seed.encode(), eng)
    torch.cuda.synchronize()
    return proof


def _verify(case, eng, blobs):
    setup = case[1]
    ok = rpm.verify(setup, rpm.decode_proof(setup, *blobs, engine=eng), eng)
    torch.cuda.synchronize()
    return ok


def _by_call(eng):
    return {k: [round(eng.seconds[k], 6), eng.calls[k]] for k in sorted(eng.calls)}


def run_case(name, eng, repeat):
    case = _load(name)
    blobs = rpm.encode_proof(case[1], _prove(case, eng))  # warm-up
    if not _verify(case, eng, blobs):
        raise AssertionError(f"{name}: warm-up proof does not verify")
    for _ in range(repeat):
        eng.reset()
        t0 = time.perf_counter()
        proof = _prove(case, eng)
        prove_s = time.perf_counter() - t0
        prove_calls = _by_call(eng)
        eng.reset()
        t0 = time.perf_counter()
        ok = _verify(case, eng, rpm.encode_proof(case[1], proof))
        verify_s = time.perf_counter() - t0
        if not ok or rpm.encode_proof(case[1], proof) != blobs:
            raise AssertionError(f"{name}: proof differs from the warm-up's or does not verify")
        yield {"case": name, "prove_s": prove_s, "verify_s": verify_s,
               "prove_by_call": prove_calls, "verify_by_call": _by_call(eng)}


def batch_proofs(indices, eng):
    """Proof i of examples/64bit (amount 10^9 + i, seed bench<i>) for each i
    of ``indices``, proved through ``eng``: (setup, [(coms bytes, proof
    bytes)])."""
    spec, setup, _ = _load("64bit")
    blobs = []
    for i in indices:
        values = cli._resolve_values(spec, schema_mod.parse_witness([{"amount": 10**9 + i}]))
        blobs.append(rpm.encode_proof(setup, rpm.prove(setup, values, f"bench{i}".encode(), eng)))
    return setup, blobs


def run_batch(setup, blobs, eng, repeat):
    """``repeat`` timed ``batch_verify_encoded`` runs over all the proofs."""
    entries = [(setup, c, p) for c, p in blobs]
    for _ in range(repeat):
        eng.reset()
        t0 = time.perf_counter()
        ok = batch_verify_encoded(entries, eng)
        eng.sync()
        verify_s = time.perf_counter() - t0
        if not ok:
            raise AssertionError("a batch of valid proofs was rejected")
        yield {"batch": len(entries), "verify_s": verify_s, "by_call": _by_call(eng),
               "host_s": verify_s - sum(eng.seconds.values()),
               "decompressed_points": eng.sizes["decompress"],
               "msm_points": eng.sizes["msm"], "msm_lanes": _bucket(2 * eng.sizes["msm"])}


def lockstep_items(n: int):
    """N examples/64bit items (setup, values, seed): amount 10^9 + i, seed
    lockstep<i>."""
    spec, setup, _ = _load("64bit")
    return [(setup, cli._resolve_values(spec, schema_mod.parse_witness([{"amount": 10**9 + i}])),
             f"lockstep{i}".encode()) for i in range(n)]


def profile_lockstep(n: int, eng):
    """One lockstep bucket of ``n`` 64bit proofs (``prove_many``) against the
    same proofs one at a time: for each route, the wall seconds of one run,
    the device seconds and idle share of another under the profiler, device
    ms and launches by wrapper, and the fold and table_flat launches
    (counted as the difference of ``kernels.counts()``, which are not
    reset)."""
    items = lockstep_items(n)
    routes = {"lockstep": lambda: prove_many(items, eng),
              "one_at_a_time": lambda: [rpm.prove(s, v, seed, eng) for s, v, seed in items]}
    out, encoded = {"profile": f"lockstep {n} x 64bit"}, {}
    for name, fn in routes.items():
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proofs = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        encoded[name] = [rpm.encode_proof(s, p) for (s, _v, _s), p in zip(items, proofs)]
        p = profiled(fn)
        out[name] = {"wall_s": wall, "device_s": p["device_s"],
                     "device_idle_share": 1 - p["device_s"] / wall,
                     "by_wrapper": by_wrapper(p["by_kernel"]), "complete": p["complete"],
                     "fold_launches": {k: p["launched"].get(k, 0)
                                       for k in ("fold", "fold_many", "table_flat")}}
    if encoded["lockstep"] != encoded["one_at_a_time"]:
        raise AssertionError("lockstep proofs differ from the ones proved one at a time")
    return out


MP_CASE = "128by64"
MP_COUNTED = ("fold", "fold_many", "table_flat", "select_reduce")


class _ShareClock:
    """A party's in-process channel that notes, on the dealer's side, the
    clock and the launch counts when the party's final share arrives."""

    def __init__(self):
        self.inner = LocalChannel()
        self.at = None

    def send(self, msg):
        self.inner.send(msg)

    def recv(self):
        return self.inner.recv()

    def dealer_send(self, msg):
        self.inner.dealer_send(msg)

    def dealer_recv(self):
        msg = self.inner.dealer_recv()
        if msg[0] == "done":
            self.at = (time.perf_counter(), kernels.counts())
        return msg


def run_multiparty(setup, values, seeds, eng, party_eng=None):
    """``cli.mp_prove_local`` (the dealer on ``eng``, ``len(seeds)`` parties
    on ``party_eng``, default ``eng``, each on a thread): (proof, (clock,
    launch counts) when the dealer held every party's final share)."""
    chans = [_ShareClock() for _ in seeds]
    proof = cli.mp_prove_local(setup, values, seeds, eng, party_eng or eng, chans)
    return proof, max(ch.at for ch in chans)


def profile_multiparty(parties: int, eng, case: str = MP_CASE):
    """Example ``case`` by ``parties`` parties and the dealer on threads over
    one engine, against one prover: for each route the wall seconds of one run
    and its fold, fold_many, table_flat and select_reduce launches (the multiparty
    route's split into the parties' and the dealer's), then the device
    seconds, idle share and device ms by wrapper of another run under the
    profiler."""
    spec, setup, values = _load(case)
    seeds = [f"mp party {k}".encode() for k in range(parties)]
    routes = {"multiparty": lambda: run_multiparty(setup, values, seeds, eng),
              "one_prover": lambda: (rpm.prove(setup, values, spec.random_seed.encode(), eng),
                                     None)}
    out = {"profile": f"multiparty {parties} x {case}"}
    for name, fn in routes.items():
        fn()  # warm-up
        torch.cuda.synchronize()
        before = kernels.counts()
        t0 = time.perf_counter()
        proof, shares_in = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = kernels.counts()
        if not rpm.verify(setup, proof, eng):
            raise AssertionError(f"the {name} proof of {case} does not verify")
        row = {"wall_s": wall, "launches": {k: after[k] - before[k] for k in MP_COUNTED}}
        if shares_in is not None:
            t_shares, at = shares_in
            row["parties"] = {"s": t_shares - t0,
                              "launches": {k: at[k] - before[k] for k in MP_COUNTED}}
            row["dealer"] = {"s": wall - (t_shares - t0),
                             "launches": {k: after[k] - at[k] for k in MP_COUNTED}}
        p = profiled(fn)
        row.update(device_s=p["device_s"], device_idle_share=1 - p["device_s"] / wall,
                   by_wrapper=by_wrapper(p["by_kernel"]), complete=p["complete"])
        out[name] = row
    return out


def profiled(fn) -> dict:
    """One call of fn under torch.profiler: its wall seconds, device
    seconds, device milliseconds (and launches) by kernel, the launches of
    the port's wrappers it made, and whether the profile holds every one
    of them (``profile_complete``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = kernels.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in kernels.counts().items() if n > before[k]}
    device_s, by_kernel = device_time(prof, top=None)
    return {"wall_s": wall, "device_s": device_s, "by_kernel": by_kernel, "launched": launched,
            "complete": profile_complete(launched, by_kernel)}


def _profile_call(label, fn):
    """fn once to warm up, once timed (wall seconds) and once ``profiled``:
    the device seconds, the idle share against the timed wall, the eight
    kernels with the most device time, the device ms and launches by
    wrapper (``by_wrapper``), the four library kernels launched most, the
    memory copies by kind (``copies``), the port's launches and whether the
    profile holds them all."""
    fn()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    p = profiled(fn)
    every = p["by_kernel"]
    library = sorted(((k, v) for k, v in every.items() if _owners(k) == ("library",)),
                     key=lambda kv: -kv[1][1])
    return {"profile": label, "wall_s": wall, "device_s": p["device_s"],
            "device_idle_share": 1 - p["device_s"] / wall,
            "top_kernels_ms_launches": dict(list(every.items())[:8]),
            "by_wrapper": by_wrapper(every), "library_top": {k[:72]: v for k, v in library[:4]},
            "copies": copies(every), "launched": p["launched"], "complete": p["complete"]}


def profile_prove(name, eng):
    """``_profile_call`` of one prove of example ``name``, with the sha256 of
    its proof bytes."""
    case = _load(name)
    proofs = []
    out = _profile_call(f"{name} prove", lambda: proofs.append(_prove(case, eng)))
    out["proof_sha256"] = hashlib.sha256(rpm.encode_proof(case[1], proofs[-1])[1]).hexdigest()
    return out


def profile_verify(name, eng):
    """``_profile_call`` of one verify (``decode_proof`` and ``verify``) of a
    proof of example ``name``; raises if it does not verify."""
    case = _load(name)
    blobs = rpm.encode_proof(case[1], _prove(case, eng))

    def verify():
        if not _verify(case, eng, blobs):
            raise AssertionError(f"{name}: the proof does not verify")

    return _profile_call(f"{name} verify", verify)


@contextlib.contextmanager
def plain_versions(names):
    """Inside the block, each kernel wrapper NAME of ``ops.kernels`` in
    ``names`` is its plain PyTorch version (``NAME_plain``); call sites look
    the wrappers up at call time, so the whole port takes the plain route."""
    saved = {name: getattr(kernels, name) for name in names}
    try:
        for name in names:
            setattr(kernels, name, getattr(kernels, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def wrappers_of(key: str) -> dict:
    """A kernel as ``device_time`` keys it (``"padd_kernel<128>"``) ->
    {wrapper of ``ops.kernels``: the entry of its ``device_kernels`` that
    names the kernel's ``__global__`` function}; a function two wrappers
    run (``horner_warp_kernel``) gives both, a library kernel none."""
    name = re.search(r"\b(\w+_kernel)\b", key)
    if not name:
        return {}
    return {wrapper: g for wrapper, k in kernels.KERNELS.items() for g in k.device_kernels
            if name.group(1) in g.split("|")}


def _owners(key: str) -> tuple:
    """The wrappers of ``ops.kernels`` that a profiled device kernel counts
    for in ``by_wrapper``: those of ``wrappers_of``, else ``("library",)``;
    copies and sets count for none."""
    owners = tuple(wrappers_of(key))
    if owners:
        return owners
    return () if key.startswith(("Memcpy", "Memset")) else ("library",)


def copies(by_kernel: dict) -> dict:
    """{kind: [ms, copies]} of the memory copies in a profile's kernels
    (``device_time``'s keys), which ``by_wrapper`` leaves out: "HtoD
    (Pinned -> Device)", "HtoD (Pageable -> Device)", "DtoH (Device ->
    Pageable)", ..."""
    out = {}
    for key, (ms, n) in by_kernel.items():
        if key.startswith("Memcpy "):
            acc = out.setdefault(key[len("Memcpy "):], [0.0, 0])
            acc[0] = round(acc[0] + ms, 4)
            acc[1] += n
    return out


def by_wrapper(by_kernel: dict) -> dict:
    """{kernel: [ms, launches]} (``device_time``'s keys) -> {wrapper of
    ``ops.kernels``: [ms, launches]} (``wrappers_of``), and under
    ``"library"`` the sum over every device kernel that no wrapper claims
    (PyTorch's own operators on the card; copies and sets left out)."""
    out = {"library": [0.0, 0]}
    for key, (ms, n) in by_kernel.items():
        for wrapper in _owners(key):
            acc = out.setdefault(wrapper, [0.0, 0])
            acc[0] = round(acc[0] + ms, 4)
            acc[1] += n
    return out


def profile_complete(launched: dict, by_kernel: dict) -> bool:
    """Whether a profile's kernels ({name: [ms, launches]}, keyed as
    ``device_time`` keys them) hold every launch in ``launched`` ({wrapper:
    launches}): each ``__global__`` function of the wrappers'
    ``device_kernels`` (or each set of alternatives, ``"a|b"``) ran as many
    times as the wrappers' launches that run it.  Matched by function name
    (``wrappers_of``), so a kernel shared by two wrappers
    (``horner_warp_kernel``) counts for both."""
    want = collections.Counter()
    for k, n in launched.items():
        for group in kernels.KERNELS[k].device_kernels:
            want[group] += n
    seen = collections.Counter()
    for key, (_, n) in by_kernel.items():
        for group in set(wrappers_of(key).values()) & want.keys():
            seen[group] += n
    return seen == want


# the profiler's own buffer requests: an event on the device's timeline
# that is no kernel
PROFILER_OVERHEAD = "Activity Buffer Request"


def device_time(prof, top: int | None = 8):
    """A finished ``torch.profiler`` run -> (device seconds in kernels and
    copies, {kernel: [ms, launches]} of the ``top`` largest, or of all
    where ``top`` is None).  Only the device's own events count (their
    ``device_type`` is CUDA): PyTorch's operators and the CUDA runtime's
    calls run on the host (in a process's first profile
    ``cudaLaunchKernel`` carries a little device time and one count a
    launch), and the profiler's buffer requests are not device work."""
    per = collections.Counter()
    launches = collections.Counter()
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and ev.device_type == DeviceType.CUDA and ev.key != PROFILER_OVERHEAD:
            key = ev.key.replace("(anonymous namespace)::", "")
            if not key.startswith(("Memcpy", "Memset")):  # a copy's key keeps its kind
                key = key.split("(")[0]
            per[key] += dev_us
            launches[key] += ev.count
    largest = {k: [round(v / 1e3, 4), launches[k]] for k, v in per.most_common(top)}
    return sum(per.values()) / 1e6, largest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="engine_profile")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--plain", action="append", default=[], choices=sorted(kernels.KERNELS))
    ap.add_argument("--batch", type=int, default=0, help="time a batch verify of N proofs")
    ap.add_argument("--lockstep", type=int, default=0,
                    help="profile a lockstep bucket of N 64bit proofs against one at a time")
    ap.add_argument("--mp", type=int, default=0,
                    help=f"profile {MP_CASE} by P parties in threads against one prover")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("engine_profile needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    with plain_versions(args.plain):
        _run(args, "plain " + ",".join(args.plain) if args.plain else "kernels")
    return 0


def _run(args, tag):
    if args.lockstep:
        print(json.dumps({"run": tag, **profile_lockstep(args.lockstep, TorchEngine("cuda"))}),
              flush=True)
        return
    if args.mp:
        print(json.dumps({"run": tag, **profile_multiparty(args.mp, TorchEngine("cuda"))}),
              flush=True)
        return
    eng = TimedEngine("cuda")
    if args.batch:
        t0 = time.perf_counter()
        setup, blobs = batch_proofs(range(args.batch), eng)
        print(json.dumps({"run": tag, "proved": args.batch, "prove_s": time.perf_counter() - t0}),
              flush=True)
        for row in run_batch(setup, blobs, eng, 1 + args.repeat):  # the first is a warm-up
            print(json.dumps({"run": tag, **row}), flush=True)
        return
    for case in ("64bit", "128by64"):
        for row in run_case(case, eng, args.repeat):
            print(json.dumps({"run": tag, **row}), flush=True)
    for case in ("64bit", "128by64"):
        for step in (profile_prove, profile_verify):
            print(json.dumps({"run": tag, **step(case, TorchEngine("cuda"))}), flush=True)

if __name__ == "__main__":
    sys.exit(main())
