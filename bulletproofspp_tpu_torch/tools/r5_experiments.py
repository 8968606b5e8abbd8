"""Where the MSM's select-and-reduce time goes on the card: five experiments.

    python -m bulletproofspp_tpu_torch.tools.r5_experiments

The counterpart of the JAX package's ``tools/r5_experiments.py``, at its
default of 32,768 points (the bench's basis, L = 65,536 GLV lanes) and 33
digit rows:

  H1  the padd kernel chained 8 deep over the basis lanes at 128, 256, 512
      and 1,024 threads a block (the TPU tool sweeps
      ``padd_pallas(block=)``): ns a lane-padd;
  H2  ``grid_copy``, one block per (1,024-lane block, row), 64 x 33 blocks:
      its time over the block count is the fixed cost of a block;
  H3  ``sr_variant`` at blk 1,024 / out 128 with the digit selection and
      without it (entry 1 for every lane), beside ``select_reduce``, the
      MSM's kernel for the same function (its staged design at this
      size), and its gather design (the rows of a lane block in
      consecutive blocks), on the same inputs;
  H4  ``sr_variant`` at blk 512, 1,024, 2,048 and out 128, 256;
  H5  ``select_reduce``'s two designs at 4,096 to 532,480 lanes a call:
      one MSM of 4,096 to 65,536 lanes, two of 65,536, and prove's
      ``msm_many`` calls of 66 MSMs of 2,048 and 98 and 130 of 4,096
      (``ops.kernels.STAGE_MIN_LANES`` picks between the designs).

Each line gives the median and IQR of CUDA-event timings of launches run
back to back (``bench.sampled`` and ``bench.cuda_ms``: repetitions double
until the IQR is under 10% of the median), ns a lane
where it applies and the kernel's bound (``bounds``).  Prints the card's
``nvidia-smi`` line first; exits 2 without CUDA.  Imports no JAX.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from .. import bounds
from ..bench import DEVICE, N_POINTS, basis, digits, sampled
from ..core.fields import R
from ..ops import kernels, limb

REP = 8
SR_CASES = ((1024, 128, False), (1024, 128, True), (2048, 256, False), (2048, 128, False),
            (512, 128, False), (512, 256, False), (1024, 256, False))


def run() -> list:
    card = bounds.card()
    mhz = card["sm_clock_max_mhz"]
    L = 2 * N_POINTS
    px, py, pz = basis(N_POINTS, DEVICE)
    rng = random.Random(7)
    absd, sgn = (d[0] for d in digits([rng.randrange(R) for _ in range(N_POINTS)], DEVICE))
    rows = []

    def report(label, fn, work, per_lane=None):
        t = sampled(fn)
        ms = t["ms"]
        b_ms, b_by = bounds.bound(work, mhz)
        row = {"case": label, "ms": ms, "iqr_ms": t["iqr_ms"], "bound_ms": b_ms, "bound_by": b_by,
               "back_to_back": t["back_to_back"]}
        extra = ""
        if per_lane:
            row["ns_per_lane"] = ms * 1e6 / per_lane
            row["bound_ns_per_lane"] = b_ms * 1e6 / per_lane
            extra = f"  {row['ns_per_lane']:8.4f} ns/lane (bound {row['bound_ns_per_lane']:.4f})"
        print(f"{label:40s} {ms:10.4f} ms (IQR {t['iqr_ms']:.4f})  bound {b_ms:.4f} ms ({b_by})"
              f"{extra}", flush=True)
        rows.append(row)
        return ms

    # H1: padd chained REP deep, by threads a block
    for threads in kernels.PADD_THREADS:
        def chain(k, threads=threads):
            p = (px, py, pz)
            for _ in range(REP):
                p = kernels.padd(p, p, threads)
            return p

        ops, nbytes = bounds.padd(L)
        report(f"H1 padd chain x{REP} threads={threads}", chain, (REP * ops, REP * nbytes),
               per_lane=REP * L)

    # H2: the fixed cost of a block
    xs = torch.as_tensor(np.random.default_rng(7).integers(0, 1 << 16, size=(limb.NLIMB, L)),
                         device=DEVICE)
    ms = report("H2 grid_copy (64 x 33 blocks of 1,024)", lambda k: kernels.grid_copy(xs, 1024),
                bounds.grid_copy(L, 33))
    print(f"{'':40s} -> {ms * 1e3 / (33 * (L // 1024)):.4f} us/block", flush=True)

    # H3, H4: select_reduce variants
    tables = kernels.table_flat((px, py, pz))
    report("H3 select_reduce (the MSM's kernel)",
           lambda k: kernels.select_reduce(tables, absd[None], sgn[None]),
           bounds.select_reduce(absd[None], sgn[None]), per_lane=L)
    report("H3 select_reduce, rows design",
           lambda k: kernels.select_reduce_design(tables, absd[None], sgn[None], False),
           bounds.select_reduce(absd[None], sgn[None]), per_lane=L)
    for blk, out_w, noselect in SR_CASES:
        tag = "H3" if blk == 1024 and out_w == 128 else "H4"
        label = f"{tag} sr blk={blk} out={out_w}" + (" NOSELECT" if noselect else "")
        report(label, lambda k: kernels.sr_variant(tables, absd, sgn, blk, out_w, noselect),
               bounds.sr_variant(absd, sgn, blk, out_w, noselect), per_lane=L)

    # H5: select_reduce's two designs by lanes a call: B MSMs on the basis
    # tables' first n lanes, MSM i's digits those lanes' rolled by 997 i;
    # (66, 2,048), (98, 4,096) and (130, 4,096) are msm_many's calls in prove
    for batch, n in ((1, 4096), (1, 16384), (1, 32768), (1, L), (2, L), (66, 2048), (98, 4096),
                     (130, 4096)):
        tabs = [t.view(-1, limb.NLIMB, L)[..., :n].repeat(1, 1, batch).reshape(t.shape[0], -1)
                for t in tables]
        ad, sg = (torch.stack([d[:, :n].roll(997 * i, 1) for i in range(batch)])
                  for d in (absd, sgn))
        for staged in (True, False):
            report(f"H5 select_reduce B={batch} L={n} {'staged' if staged else 'rows'}",
                   lambda k: kernels.select_reduce_design(tabs, ad, sg, staged),
                   bounds.select_reduce(ad, sg), per_lane=batch * n)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("r5_experiments: CUDA is not available; the tool runs on the card only",
              file=sys.stderr)
        return 2
    card = bounds.card()
    print(f"{card['name']}, {card['power_limit_w']:.2f} W", flush=True)
    return 0 if all(r["back_to_back"] for r in run()) else 1


if __name__ == "__main__":
    sys.exit(main())
