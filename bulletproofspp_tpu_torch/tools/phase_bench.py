"""Each phase of the complete addition as its own chained kernel, on the card.

    python -m bulletproofspp_tpu_torch.tools.phase_bench

The counterpart of the JAX package's ``tools/phase_bench.py``: the chain
kernel (``ops.kernels.chain``) runs x <- step(x, b) REP = 8 times a lane
over L = 65,536 lanes of random 16-bit limbs for each phase of
``kernels.CHAIN_PHASES``, timed as ``bench.sampled`` times (median and
IQR of CUDA-event samples of launches run back to back), and prints ns
a lane-step beside the phase's bound (``bounds.chain``: its 32-bit
multiplies over the card's rate, or
its bytes over 3.35 TB/s; the JAX tool's ``bench._measure_rate`` does not
exist, so its bound could not be computed).  Then the sum of the phases
weighted by their count in one complete add against the padd phase.
Prints the card's ``nvidia-smi`` line first; exits 2 without CUDA.
Imports no JAX.
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
# count of each phase in one complete add of the JAX body (phase_bench.PHASES)
MULTIPLICITY = {"mul_w16": 12, "mul_small": 3, "add": 3, "add_s17": 6, "sub": 5}


def run() -> dict:
    card = bounds.card()
    rng = np.random.default_rng(5)

    def mk():
        return torch.as_tensor(rng.integers(0, 1 << 16, size=(limb.NLIMB, L)), device=DEVICE)

    results = {}
    for name, (_, nstate, value) in kernels.CHAIN_PHASES.items():
        a = tuple(mk() for _ in range(nstate))
        b = tuple(mk() for _ in range(3))
        t = sampled(lambda k: kernels.chain(name, a, b, REP))
        ms = t["ms"]
        b_ms, b_by = bounds.bound(bounds.chain(name, L, REP), card["sm_clock_max_mhz"])
        ns, bound_ns = ms * 1e6 / REP / L, b_ms * 1e6 / REP / L
        iqr = t["iqr_ms"] * 1e6 / REP / L
        results[name] = {"ns_per_lane": ns, "iqr_ns": iqr, "bound_ns_per_lane": bound_ns,
                         "bound_by": b_by, "value_phase": value, "back_to_back": t["back_to_back"]}
        print(f"{name:12s} {ns:9.4f} ns/lane (IQR {iqr:.4f})   bound {bound_ns:8.4f} ({b_by})   "
              f"bound/time {bound_ns / ns:6.3f}", flush=True)
    tot = sum(results[n]["ns_per_lane"] * m for n, m in MULTIPLICITY.items())
    print(f"\nsum(phases x multiplicity) {tot:.4f} ns vs padd {results['padd']['ns_per_lane']:.4f} ns",
          flush=True)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_bench: CUDA is not available; the tool runs on the card only", file=sys.stderr)
        return 2
    card = bounds.card()
    print(f"{card['name']}, {card['power_limit_w']:.2f} W", flush=True)
    return 0 if all(r["back_to_back"] for r in run().values()) else 1


if __name__ == "__main__":
    sys.exit(main())
