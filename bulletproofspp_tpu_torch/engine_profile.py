"""Where the time of a prove and a verify goes on the card, by engine call.

    python -m bulletproofspp_tpu_torch.engine_profile [--repeat 2] [--plain fold]

For examples/64bit and examples/128by64: one warm-up prove and verify,
then ``--repeat`` timed runs of each.  Every ``TorchEngine`` call is
wrapped with ``torch.cuda.synchronize()`` on both sides and its seconds
are summed by kind (``msm_many``, ``fold_bv``, ...).  Prove seconds are
those of ``range_proof.prove``; verify seconds those of ``decode_proof``
and ``verify``.  Then one 64bit prove runs under ``torch.profiler``: the
device time of each kernel, their sum, and the device's idle share
against the wall time of the same prove without the profiler.

``--plain NAME`` swaps kernel NAME's wrapper (``ops.kernels``) for its
plain PyTorch version for the whole run, to see what the kernel saves end
to end.  Output: the card's ``nvidia-smi`` line, then one JSON object per
run and one for the profile.  Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

from bulletproofspp_tpu import cli as base_cli
from bulletproofspp_tpu.core import range_proof as rpm
from bulletproofspp_tpu.io_ import schema as schema_mod

from .ops import kernels
from .ops.engine import TorchEngine

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
CALLS = ("basevec", "bv_pad", "bv_split", "msm", "msm_many", "fold_bv", "complete_square",
         "decompress")


class TimedEngine(TorchEngine):
    """TorchEngine whose outermost calls are synchronized and timed by kind
    (a call made from inside another, such as msm -> msm_many, counts only
    in the outer one)."""

    def __init__(self, device):
        super().__init__(device)
        self.seconds = collections.defaultdict(float)
        self.calls = collections.Counter()
        self._depth = 0

    def reset(self):
        self.seconds.clear()
        self.calls.clear()


def _timed(name):
    inner = getattr(TorchEngine, name)

    def call(self, *a, **k):
        if self._depth:
            return inner(self, *a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._depth += 1
        try:
            return inner(self, *a, **k)
        finally:
            self._depth -= 1
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    return call


for _name in CALLS:
    setattr(TimedEngine, _name, _timed(_name))


def _load(name):
    d = os.path.join(EXAMPLES, name)
    with open(os.path.join(d, "schema.json")) as f:
        spec = schema_mod.parse_spec(json.load(f))
    setup = schema_mod.build_setup(spec, base_cli.load_points(spec, schema_mod.points_needed(spec)))
    with open(os.path.join(d, "witness.json")) as f:
        values = base_cli._resolve_values(spec, schema_mod.parse_witness(json.load(f)))
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


def profile_prove(name, eng):
    """Device time per kernel over one prove, and the idle share against
    the wall time of one prove without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    case = _load(name)
    _prove(case, eng)
    t0 = time.perf_counter()
    _prove(case, eng)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _prove(case, eng)
    per = collections.Counter()
    launches = collections.Counter()
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0 and not ev.key.startswith("aten::"):
            key = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            per[key] += dev_us
            launches[key] += ev.count
    device_s = sum(per.values()) / 1e6
    top = {k: [round(v / 1e3, 4), launches[k]] for k, v in per.most_common(8)}
    return {"profile": name, "prove_wall_s": wall, "device_s": device_s,
            "device_idle_share": 1 - device_s / wall, "top_kernels_ms_launches": top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="engine_profile")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--plain", action="append", default=[], choices=sorted(kernels.KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("engine_profile needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    for name in args.plain:
        setattr(kernels, name, getattr(kernels, f"{name}_plain"))
    eng = TimedEngine("cuda")
    tag = "plain " + ",".join(args.plain) if args.plain else "kernels"
    for case in ("64bit", "128by64"):
        for row in run_case(case, eng, args.repeat):
            print(json.dumps({"run": tag, **row}), flush=True)
    print(json.dumps({"run": tag, **profile_prove("64bit", TorchEngine("cuda"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
