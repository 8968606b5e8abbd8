"""Each phase of the complete addition as its own chained kernel, on the card.

    python -m bulletproofspp_tpu_torch.tools.phase_bench

The counterpart of the JAX package's ``tools/phase_bench.py``: the chain
kernel (``ops.kernels.chain``) runs x <- step(x, b) a lane for each phase
of ``kernels.CHAIN_PHASES``, whose steps are ``csrc/field.cuh``'s functions.
Two rows a phase:

  throughput  REP = 8 steps over L = 65,536 lanes of random 16-bit limbs,
              timed as ``bench.sampled`` times (median and IQR of
              CUDA-event samples of launches run back to back): ns a
              lane-step beside the phase's bound (``bounds.chain``: its
              32-bit multiplies over the card's rate, or its bytes over
              3.35 TB/s; the JAX tool's ``bench._measure_rate`` does not
              exist, so its bound could not be computed);
  latency     one warp (LAT_L = 32 lanes), LAT_REP and 2 x LAT_REP dependent
              steps: ns and SM cycles (at ``clocks.max.sm``) a dependent
              step from the difference of the two, so the launch's own
              time drops out, and the launch's share of the LAT_REP launch
              (under 5%).

Then the sum of the phases weighted by their count in one complete add
against the padd phase.  Then the rounds of the fold chain
(``kernels.ROUND_PHASES``, where the checkout has them): for each, on one
warp (ROUND_LANES = 2 lanes of 16 threads), ns and SM cycles
a product round (half a dependent addition or doubling, by the latency
method above over ROUND_REP steps) and, from a run with the kernel's
clocks on, the SM cycles a round of each part (``kernels.ROUND_PARTS``:
forming the operands, the product, the split product's combination, the
broadcast, the cheap steps); and a fold_rows round of each design (4
doublings and 2 additions a row).  Prints the card's ``nvidia-smi`` line
first; exits 2 without CUDA.  Imports no JAX.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import bounds
from ..bench import DEVICE, sampled
from ..ops import kernels, limb

L = 65536
REP = 8
LAT_L = 32  # one warp: each step waits on the one before it
LAT_REP = 4096
# count of each phase in one complete add of the JAX body (phase_bench.PHASES)
MULTIPLICITY = {"mul_w16": 12, "mul_small": 3, "add": 3, "add_s17": 6, "sub": 5}
ROUND_LANES = 2  # one warp of two 16-thread groups
ROUND_REP = 1024


def latency(name: str, a, b, mhz: float) -> dict:
    """ns and SM cycles a dependent step of phase ``name`` on one warp: the
    time of 2 LAT_REP steps less that of LAT_REP, over LAT_REP; and the
    share of the LAT_REP launch that is not its steps (the launch's own)."""
    a = tuple(t[:, :LAT_L].contiguous() for t in a)
    b = tuple(t[:, :LAT_L].contiguous() for t in b)
    t1, t2 = (sampled(lambda k, r=r: kernels.chain(name, a, b, r)) for r in (LAT_REP, 2 * LAT_REP))
    ns = (t2["ms"] - t1["ms"]) * 1e6 / LAT_REP
    return {"latency_ns": ns, "latency_cycles": ns * mhz / 1e3,
            "latency_launch_share": 1 - ns * LAT_REP / (t1["ms"] * 1e6),
            "latency_back_to_back": t1["back_to_back"] and t2["back_to_back"]}


def rounds(mhz: float) -> dict:
    """Each round phase on one warp: ns and SM cycles a product round (two
    a step) by the latency method, and the parts' SM cycles a round of lane
    0 from the clocked run; then each design's fold_rows round."""
    phases = getattr(kernels, "ROUND_PHASES", {})
    rng = np.random.default_rng(7)

    def mk():
        return torch.as_tensor(rng.integers(0, 1 << 16, size=(limb.NLIMB, ROUND_LANES)),
                               device=DEVICE)

    out = {}
    for name in phases:
        a, b = tuple(mk() for _ in range(3)), tuple(mk() for _ in range(3))
        t1, t2 = (sampled(lambda k, r=r: kernels.round_chain(name, a, b, r))
                  for r in (ROUND_REP, 2 * ROUND_REP))
        ns = (t2["ms"] - t1["ms"]) * 1e6 / ROUND_REP / 2
        clocks = torch.zeros((len(kernels.ROUND_PARTS), ROUND_LANES), dtype=torch.int64,
                             device=DEVICE)
        kernels.round_chain(name, a, b, ROUND_REP, clocks)
        parts = {p: int(c) / ROUND_REP / 2 for p, c in zip(kernels.ROUND_PARTS, clocks[:, 0])}
        out[name] = {"round_ns": ns, "round_cycles": ns * mhz / 1e3, "parts_cycles": parts,
                     "back_to_back": t1["back_to_back"] and t2["back_to_back"]}
        print(f"round {name:10s} one warp: {ns:8.2f} ns ({ns * mhz / 1e3:7.1f} SM cycles) a "
              "product round; clocked, SM cycles a round: "
              + ", ".join(f"{p} {c:.1f}" for p, c in parts.items())
              + f" (sum {sum(parts.values()):.1f})", flush=True)
    for design in ("warp", "split"):
        if f"add_{design}" in out:  # a row: 4 doublings and 2 additions, 2 rounds each
            ns = (4 * out[f"dbl_{design}"]["round_ns"] + 2 * out[f"add_{design}"]["round_ns"]) / 6
            out[f"fold_rows_{design}"] = {"round_ns": ns}
            print(f"fold_rows {design:5s} one warp: {ns:8.2f} ns a product round "
                  f"(4 doublings + 2 additions a row)", flush=True)
    return out


def run() -> dict:
    card = bounds.card()
    mhz = card["sm_clock_max_mhz"]
    rng = np.random.default_rng(5)

    def mk():
        return torch.as_tensor(rng.integers(0, 1 << 16, size=(limb.NLIMB, L)), device=DEVICE)

    results = {}
    for name, (_, nstate, value) in kernels.CHAIN_PHASES.items():
        a = tuple(mk() for _ in range(nstate))
        b = tuple(mk() for _ in range(3))
        t = sampled(lambda k: kernels.chain(name, a, b, REP))
        ms = t["ms"]
        b_ms, b_by = bounds.bound(bounds.chain(name, L, REP), mhz)
        ns, bound_ns = ms * 1e6 / REP / L, b_ms * 1e6 / REP / L
        iqr = t["iqr_ms"] * 1e6 / REP / L
        lat = latency(name, a, b, mhz)
        results[name] = {"ns_per_lane": ns, "iqr_ns": iqr, "bound_ns_per_lane": bound_ns,
                         "bound_by": b_by, "value_phase": value,
                         "back_to_back": t["back_to_back"] and lat["latency_back_to_back"], **lat}
        print(f"{name:12s} {ns:9.4f} ns/lane (IQR {iqr:.4f})   bound {bound_ns:8.4f} ({b_by})   "
              f"bound/time {bound_ns / ns:6.3f}   one warp: {lat['latency_ns']:9.2f} ns "
              f"({lat['latency_cycles']:7.1f} SM cycles) a dependent step, launch "
              f"{lat['latency_launch_share']:.1%}", flush=True)
    tot = sum(results[n]["ns_per_lane"] * m for n, m in MULTIPLICITY.items())
    print(f"\nsum(phases x multiplicity) {tot:.4f} ns vs padd {results['padd']['ns_per_lane']:.4f} ns",
          flush=True)
    results.update(rounds(mhz))
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_bench: CUDA is not available; the tool runs on the card only", file=sys.stderr)
        return 2
    card = bounds.card()
    print(f"{card['name']}, {card['power_limit_w']:.2f} W", flush=True)
    return 0 if all(r.get("back_to_back", True) for r in run().values()) else 1


if __name__ == "__main__":
    sys.exit(main())
