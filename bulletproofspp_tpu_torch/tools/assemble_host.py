"""Host microseconds of one ``kernels.assemble`` call, beside its device time.

    python -m bulletproofspp_tpu_torch.tools.assemble_host

Two shapes: a fold's two padded bases (S = 2 outputs of K = 1 entry, 15
and 14 lanes to L = 16: the main path's commonest call) and msm_many's
largest call (K = 130 entries of 4 segments of 3-5 lanes, interleaved
with phi to L = 64).  For each, the host's time a call (``ROUNDS`` calls
issued one after another, each sample the mean, ``SAMPLES`` samples: the
device keeps up, so this is the wrapper's own time: building the segment
table and launching) and the device's time a call back to back
(``bench.cuda_ms``).  It calls only ``kernels.assemble``, so the same
file can time another checkout's wrapper: copy it into that checkout's
``tools/`` and run it there.  Prints the card's line, then one JSON line.
Exits 2 without CUDA.  Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

from .. import bounds
from ..bench import cuda_ms, sampled
from ..ops import kernels, limb

ROUNDS = 64
SAMPLES = 9


def shapes(dev) -> dict:
    """{name: (outputs, L, interleave)} over one pool of random limbs."""
    g = torch.Generator(device="cpu").manual_seed(17)
    pool = tuple(torch.randint(0, limb.MASK + 1, (limb.NLIMB, 8192), generator=g).to(dev)
                 for _ in range(3))
    fold = [[[tuple(c[:, 0:15] for c in pool)]], [[tuple(c[:, 100:114] for c in pool)]]]
    oracle = [[[tuple(c[:, 7 * k + g:7 * k + g + 3 + (k + g) % 3] for c in pool)
                for g in range(4)] for k in range(130)]]
    return {"S=2 K=1 L=16": (fold, 16, False), "S=1 K=130 L=64 interleave": (oracle, 64, True)}


def host_us(fn) -> dict:
    """Median and spread of the host's microseconds a call of fn()."""
    fn()
    torch.cuda.synchronize()
    xs = []
    for _ in range(SAMPLES):
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            fn()
        xs.append((time.perf_counter() - t0) * 1e6 / ROUNDS)
        torch.cuda.synchronize()
    q1, _, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"host_us": statistics.median(xs), "iqr_us": q3 - q1}


def run() -> dict:
    dev = torch.device("cuda", 0)
    kernels.lib()  # build before timing
    out = {}
    for name, (outputs, L, interleave) in shapes(dev).items():
        def call(k=0, outputs=outputs, L=L, interleave=interleave):
            return kernels.assemble(outputs, L, interleave)

        row = host_us(call)
        t = sampled(call, cuda_ms)
        row.update(device_ms=t["ms"], device_iqr_ms=t["iqr_ms"], back_to_back=t["back_to_back"])
        kernels.reset_counts()
        call()
        row["launches"] = kernels.counts()["assemble"]
        out[name] = row
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("assemble_host: CUDA is not available; the tool runs on the card only",
              file=sys.stderr)
        return 2
    card = bounds.card()
    print(f"{card['name']}, {card['power_limit_w']:.2f} W", flush=True)
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
