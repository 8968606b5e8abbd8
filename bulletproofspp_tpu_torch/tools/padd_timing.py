"""Why the padd chain's ns a lane-padd moved between processes: the chain
timed four ways, with the SM clock beside it.

    python -m bulletproofspp_tpu_torch.tools.padd_timing

At the bench's width (L = 65,536 lanes) the padd kernel is chained
``bench.PADD_CHAIN`` = 32 deep on (a) one point in every lane and (b) the
bench's distinct basis lanes, each timed between two CUDA events

  * ``paced``: the calls launched as the host gets to them, so the device
    waits wherever a launch's host side takes longer than the launch;
  * ``back_to_back``: the calls enqueued while the stream sleeps
    (``bench.cuda_ms``), so they run without gaps.

Beside each: the host microseconds to launch one padd call (measured while
the stream sleeps, so the host never waits on the device) and the SM clock
(``nvidia-smi`` ``clocks.sm``, MHz) sampled by a thread while the chain
runs for a second.  Medians and IQRs as ``bench.sampled`` gives them.
Prints the card's line, then one JSON line.  Exits 2 without CUDA.
Imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import torch

from .. import bounds
from ..bench import DEVICE, N_POINTS, PADD_CHAIN, basis, cuda_ms, events_ms, sampled
from ..ops import kernels, limb

CLOCK_SECONDS = 1.0


def sm_clock_samples(fn) -> list:
    """SM clock readings (MHz) taken while fn(k) runs back to back for
    CLOCK_SECONDS."""
    readings, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                check=True, capture_output=True, text=True, timeout=60)
            readings.append(float(out.stdout.split()[0]))
            time.sleep(0.05)

    t = threading.Thread(target=poll)
    t.start()
    try:
        t0, k = time.perf_counter(), 0
        while time.perf_counter() - t0 < CLOCK_SECONDS or not readings:
            fn(k)
            k += 1
            if k % 8 == 0:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    finally:
        stop.set()
        t.join()
    return readings


def host_us_per_launch(fn) -> float:
    """Host microseconds to launch one padd call of fn, the stream asleep."""
    torch.cuda._sleep(1 << 26)
    t0 = time.perf_counter()
    fn(0)
    us = (time.perf_counter() - t0) * 1e6 / PADD_CHAIN
    torch.cuda.synchronize()
    return us


def run() -> dict:
    L = 2 * N_POINTS
    px, py, pz = basis(N_POINTS, DEVICE)
    lanes = {"one_point": tuple(t[:, :1].expand(limb.NLIMB, L).contiguous() for t in (px, py, pz)),
             "distinct": (px, py, pz)}
    out = {}
    for name, P in lanes.items():
        def chain(k, P=P):
            p = P
            for _ in range(PADD_CHAIN):
                p = kernels.padd(p, p)
            return p

        row = {}
        for clock_name, clock in (("paced", events_ms), ("back_to_back", cuda_ms)):
            t = sampled(chain, clock)
            clocks = sm_clock_samples(chain)
            row[clock_name] = {"ns_per_lane": t["ms"] * 1e6 / PADD_CHAIN / L,
                               "iqr_ns": t["iqr_ms"] * 1e6 / PADD_CHAIN / L,
                               "back_to_back": t["back_to_back"],
                               "sm_mhz_median": statistics.median(clocks),
                               "sm_mhz_min": min(clocks), "sm_mhz_max": max(clocks)}
        row["host_us_per_launch"] = host_us_per_launch(chain)
        out[name] = row
        print(f"{name:10s} paced {row['paced']['ns_per_lane']:.4f} ns/lane  back to back "
              f"{row['back_to_back']['ns_per_lane']:.4f} ns/lane  host "
              f"{row['host_us_per_launch']:.1f} us/launch  SM clock "
              f"{row['back_to_back']['sm_mhz_median']:.0f} MHz", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("padd_timing: CUDA is not available; the tool runs on the card only", file=sys.stderr)
        return 2
    card = bounds.card()
    print(f"{card['name']}, {card['power_limit_w']:.2f} W", flush=True)
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
