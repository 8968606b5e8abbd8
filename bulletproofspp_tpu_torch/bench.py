"""The port's MSM bench on one CUDA card: the 32,768-point fixed-basis MSM.

    python -m bulletproofspp_tpu_torch.bench

The counterpart of the JAX package's ``bench_msm`` and ``roofline``
(``bench.py:93-404``).  The basis is the doublings G, 2G, 4G, ... of
N_POINTS = 32,768 points (L = 65,536 GLV lanes, [P, phi(P)]
interleaved), packed once; its multiple tables are built once
(``ops.msm.precompute_flat_table``).  Each call takes fresh scalars, one
of N_SETS = 8 seeded sets, recoded by the port's ``native`` / ``glv``.

Measured, each as the median of 7 samples whose repetitions double until
the samples' IQR is under 10% of their median:

  * the device time of the tabled MSM (``msm_tabled``: select_reduce, the
    reduce_block chain, tail_horner; 33 complete adds a lane) and of the
    untabled one (``msm``: table_flat first; 40 adds a lane), from CUDA
    events around back-to-back calls that the host enqueued while the
    stream slept (``cuda_ms``), so the host's pace does not enter;
  * the tabled MSM end to end with the host scalar preparation (recode,
    upload, MSM, fetch of the result), by the host clock after
    ``torch.cuda.synchronize()``;
  * the padd kernel chained 32 deep over the basis lanes: ns per
    lane-padd, timed as the MSMs are (a launch takes ~35 us on the card
    and 70-120 us of host time, so launches sent one at a time measure
    the host: ``tools/padd_timing.py``);
  * one tabled and one untabled MSM, and one end-to-end call, under
    ``torch.profiler``: device milliseconds by kernel, and the device's
    idle share of the end-to-end call's wall time.  A profile that misses
    a launch of the port's kernels (counted by ``ops.kernels``, matched
    to the profile by each wrapper's ``device_kernels``) is reported as
    incomplete, and its idle share as null: not measured.

``roofline_util`` = adds a lane x L x t_padd / MSM time: how close the
assembled pipeline comes to its own complete-add kernel.  ``bound_share``
= the MSM's bound (``bounds``: its 32-bit multiplies over the card's rate,
or its bytes over 3.35 TB/s) / its time.  A share above 1 is flagged in
``above_1``, never rounded away.  Every MSM of every set is checked
against the exact answer (sum_i s_i 2^i mod R) G, one host scalar
multiplication, and tabled must equal untabled.

Prints the card's ``nvidia-smi`` line, then ONE JSON line, which leads
with the reference's keys: ``metric``, ``value`` (tabled points/s),
``unit`` and ``vs_baseline`` (the tabled bound share).  Exits 0 when
the MSMs are right and every device time was back to back with its IQR
under its limit, 1 otherwise, and 2 without CUDA: there is no CPU
carry-on.  Imports no JAX.
"""

from __future__ import annotations

import collections
import json
import random
import statistics
import sys
import time

import numpy as np
import torch

from . import bounds, native
from .core import ec
from .core.fields import R
from .ops import curve, kernels, msm
from .ops.engine import _interleave_endo

N_POINTS = 32768
N_SETS = 8
DEVICE = torch.device("cuda")
SAMPLES = 7
IQR_LIMIT = 0.10
MAX_INNER = 256
PADD_CHAIN = 32
LEAD_CYCLES = 1 << 22  # ~2 ms of device sleep at 1.98 GHz, doubled as needed
MAX_LEAD_CYCLES = 1 << 28


def events_ms(fn, inner: int, lead: int = 0):
    """(device milliseconds per call of fn(k), k < inner, between two CUDA
    events; whether the stream was still asleep when the host had enqueued
    the last call).  With ``lead`` cycles of device sleep first the calls
    run back to back however slowly the host sends them; with none, the
    device waits on the host wherever a launch is shorter than its host
    side."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if lead:
        torch.cuda._sleep(lead)
    start.record()
    for k in range(inner):
        fn(k)
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / inner, ahead


def cuda_ms(fn, inner: int):
    """(device milliseconds per call of fn(k), back to back; whether they
    were): ``events_ms`` with a lead that doubles from LEAD_CYCLES until
    the host finishes enqueuing before the stream wakes.  Past
    MAX_LEAD_CYCLES (a host that blocks, or more launches than the queue
    holds) the time is returned with False."""
    lead = LEAD_CYCLES
    while True:
        ms, ahead = events_ms(fn, inner, lead)
        if ahead or lead >= MAX_LEAD_CYCLES:
            return ms, ahead
        lead *= 2


def host_ms(fn, inner: int):
    """(host-clock milliseconds per call of fn(k), synchronized at the end;
    True)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(inner):
        fn(k)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / inner, True


def sampled(fn, clock=cuda_ms, inner: int = 1) -> dict:
    """Median and IQR of SAMPLES samples of ``clock(fn, inner)``, ``inner``
    doubling until the IQR is under IQR_LIMIT of the median (or MAX_INNER
    is reached: then ``iqr_ok`` is False).  ``back_to_back``: every sample
    was."""
    fn(0)  # warm-up
    torch.cuda.synchronize()
    while True:
        xs, flags = zip(*(clock(fn, inner) for _ in range(SAMPLES)))
        q1, _, q3 = statistics.quantiles(xs, n=4, method="inclusive")
        med, iqr = statistics.median(xs), q3 - q1
        if iqr < IQR_LIMIT * med or inner >= MAX_INNER:
            return {"ms": med, "iqr_ms": iqr, "inner": inner, "iqr_ok": iqr < IQR_LIMIT * med,
                    "back_to_back": all(flags)}
        inner *= 2


def basis(n_points: int, device):
    """The doublings G, 2G, 4G, ... as GLV lanes (16, 2 n) on ``device``."""
    pts, p = [], ec.G
    for _ in range(n_points):
        pts.append(p)
        p = ec.dbl(p)
    return _interleave_endo(*curve.from_affine_host(pts, device))


def scalar_sets(n_points: int, n_sets: int) -> list:
    """``n_sets`` lists of ``n_points`` scalars mod R, set i from the seed
    2024 + i."""
    rngs = [random.Random(2024 + i) for i in range(n_sets)]
    return [[rng.randrange(R) for _ in range(n_points)] for rng in rngs]


def digits(scalars, device):
    """Host scalars -> (1, ROWS, L) int64 digit planes on ``device``."""
    absd, sgn = native.glv_recode_batch(scalars)
    return tuple(torch.from_numpy(d.astype(np.uint8)).to(device).to(torch.int64)[None]
                 for d in (absd, sgn))


def _msm_work(absd, sgn, tabled: bool, L: int):
    """(multiplies, bytes) of one MSM as one function: the adds of its
    route; its inputs (the selected table entries, or the points when the
    tables are built inside) and digits, one point out."""
    rows = absd.shape[1]
    ops = bounds.select_reduce(absd, sgn)[0]
    width = L // 8
    while width > 128:
        f = min(8, width // 128)
        ops += bounds.reduce_block(rows * width, f)[0]
        width //= f
    ops += bounds.tail_horner(1, rows)[0]
    if tabled:
        reads = bounds.select_reduce(absd, sgn)[1] - (rows * L // 8) * bounds.PT_BYTES
    else:
        ops += bounds.table_flat(L)[0]
        reads = L * bounds.PT_BYTES + rows * L * 16
    return ops, reads + bounds.PT_BYTES


def _profile(fn) -> dict:
    """One call of fn(0) under torch.profiler: its wall seconds, device
    seconds, device milliseconds (and launches) by kernel, and whether the
    profile holds every launch of the port's kernels that the call made."""
    from torch.profiler import ProfilerActivity, profile

    from .engine_profile import device_time

    torch.cuda.synchronize()
    before = kernels.counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in kernels.counts().items() if n > before[k]}
    device_s, by_kernel = device_time(prof, top=None)
    return {"wall_s": wall, "device_s": device_s, "by_kernel": by_kernel,
            "complete": profile_complete(launched, by_kernel)}


def profile_complete(launched: dict, by_kernel: dict) -> bool:
    """Whether a profile's kernels ({name: [ms, launches]}, keyed as
    ``engine_profile.device_time`` keys them) hold every launch in
    ``launched`` ({wrapper: launches}): each ``__global__`` function of the
    wrappers' ``device_kernels`` (or each set of alternatives, ``"a|b"``)
    ran as many times as the wrappers' launches that run it.  Matched by
    function name (``engine_profile.wrappers_of``), so a kernel shared by
    two wrappers (``horner_warp_kernel``) counts for both."""
    from .engine_profile import wrappers_of

    want = collections.Counter()
    for k, n in launched.items():
        for group in kernels.KERNELS[k].device_kernels:
            want[group] += n
    seen = collections.Counter()
    for key, (_, n) in by_kernel.items():
        for group in set(wrappers_of(key).values()) & want.keys():
            seen[group] += n
    return seen == want


def run() -> dict:
    """The bench; returns its result line as a dict."""
    card = bounds.card()
    n_points, n_sets, dev = N_POINTS, N_SETS, DEVICE
    kernels.lib()  # build and load first: the table time below is the kernel's
    L = 2 * n_points
    px, py, pz = basis(n_points, dev)
    if not msm.tabled_supported(L):
        raise ValueError(f"{n_points} points ({L} lanes) is outside the tabled route")
    t0 = time.perf_counter()
    tables = msm.precompute_flat_table(px, py, pz)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0

    sets = scalar_sets(n_points, n_sets)
    dig = [digits(s, dev) for s in sets]
    planes = tuple(t[:, None] for t in (px, py, pz))

    def tabled_call(k):
        return msm.msm_tabled(tables, *dig[k % n_sets])

    def untabled_call(k):
        return msm.msm(*planes, *dig[k % n_sets])

    correct = True
    for k, s in enumerate(sets):
        want = ec.scalar_mul(sum(v << i for i, v in enumerate(s)) % R, ec.G)
        got_t = curve.to_affine_host(tabled_call(k))[0]
        got_u = curve.to_affine_host(untabled_call(k))[0]
        correct &= got_t == got_u == want

    def e2e_call(k):
        d = digits(sets[k % n_sets], dev)
        return curve.normalize3(*msm.msm_tabled(tables, *d)).cpu()

    def padd_chain(k):
        p = (px, py, pz)
        for _ in range(PADD_CHAIN):
            p = kernels.padd(p, p)
        return p

    t_tab = sampled(tabled_call)
    t_untab = sampled(untabled_call)
    t_e2e = sampled(e2e_call, host_ms)
    t_padd = sampled(padd_chain)
    ns_padd = t_padd["ms"] * 1e6 / PADD_CHAIN / L
    profiled = {name: _profile(fn) for name, fn in
                (("tabled", tabled_call), ("untabled", untabled_call), ("e2e", e2e_call))}

    out = {
        "metric": f"msm_{n_points}pt_throughput",
        "card": card["name"], "power_limit_w": card["power_limit_w"],
        "sm_clock_max_mhz": card["sm_clock_max_mhz"],
        "n_points": n_points, "lanes": L, "scalar_sets": n_sets,
        "scalar_pipeline": native.pipeline(),
        "correct": correct,
        "kernel_build_s": kernels.build_seconds(),
        "table_build_s": table_s,
        "points_per_s_tabled": n_points / (t_tab["ms"] * 1e-3),
        "points_per_s_untabled": n_points / (t_untab["ms"] * 1e-3),
        "points_per_s_e2e_tabled": n_points / (t_e2e["ms"] * 1e-3),
        "msm_device_ms_tabled": t_tab["ms"], "msm_device_iqr_ms_tabled": t_tab["iqr_ms"],
        "msm_device_ms_untabled": t_untab["ms"], "msm_device_iqr_ms_untabled": t_untab["iqr_ms"],
        "msm_e2e_ms_tabled": t_e2e["ms"], "msm_e2e_iqr_ms_tabled": t_e2e["iqr_ms"],
        "padd_ns_per_lane": ns_padd,
        "padd_ns_iqr": t_padd["iqr_ms"] * 1e6 / PADD_CHAIN / L,
        "inner_reps": {k: v["inner"] for k, v in
                       (("tabled", t_tab), ("untabled", t_untab), ("e2e", t_e2e), ("padd", t_padd))},
        "iqr_ok": all(v["iqr_ok"] for v in (t_tab, t_untab, t_e2e, t_padd)),
        "back_to_back": all(v["back_to_back"] for v in (t_tab, t_untab, t_padd)),
        "profile_device_ms_by_kernel": {k: v["by_kernel"] for k, v in profiled.items()},
        "profile_complete": {k: v["complete"] for k, v in profiled.items()},
        "e2e_profile_device_idle_share": (1 - profiled["e2e"]["device_s"] / profiled["e2e"]["wall_s"]
                                          if profiled["e2e"]["complete"] else None),
    }
    for name, t, adds in (("tabled", t_tab, 33), ("untabled", t_untab, 40)):
        b_ms, b_by = bounds.bound(_msm_work(*dig[0], name == "tabled", L), card["sm_clock_max_mhz"])
        out[f"roofline_util_{name}"] = adds * L * ns_padd * 1e-6 / t["ms"]
        out[f"msm_bound_ms_{name}"] = b_ms
        out[f"msm_bound_by_{name}"] = b_by
        out[f"bound_share_{name}"] = b_ms / t["ms"]
    pb_ms, pb_by = bounds.bound(bounds.padd(L), card["sm_clock_max_mhz"])
    out["padd_bound_ns_per_lane"] = pb_ms * 1e6 / L
    out["padd_bound_by"] = pb_by
    out["above_1"] = sorted(k for k, v in out.items()
                            if (k.startswith("roofline_util") or k.startswith("bound_share")) and v > 1)
    return out


def line(out: dict) -> str:
    """The bench's JSON line: ``out`` behind the reference's headline keys
    (``bench.py:827-838``): ``value`` the tabled MSM's points/s, ``unit``,
    and ``vs_baseline`` its bound share, the chip-relative share nearest to
    the reference's ``chip_util``."""
    return json.dumps({"metric": out["metric"], "value": out["points_per_s_tabled"],
                       "unit": "points/s", "vs_baseline": out["bound_share_tabled"], **out})


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: CUDA is not available; the bench runs on the card only", file=sys.stderr)
        return 2
    out = run()
    print(f"{out['card']}, {out['power_limit_w']:.2f} W", flush=True)
    print(line(out), flush=True)
    return 0 if out["correct"] and out["iqr_ok"] and out["back_to_back"] else 1


if __name__ == "__main__":
    sys.exit(main())
