"""Kernel times at the main paths' shapes, for two checkouts on one card.

    python -m bulletproofspp_tpu_torch.tools.kernel_turns [--label NAME] [--quick]

Builds the kernels of the checkout it runs from (``ops.kernels.lib``) and
times each case below back to back (``bench.sampled``: the median of
CUDA-event samples, repetitions doubling until the IQR is under 10%), on
numpy-seeded inputs at the shapes of ``chip_smoke.py``'s kernel rows: the
wide and narrow padd, table_flat, reduce_block, tail_horner (K = 1, 8, 16
and 130, and K = 2 from the tables, canonical), horner (K = 1 and 130), fold,
fold_many (B = 1 at 16, 512 and 4,096 lanes beside table_flat x 2 + fold,
the one-prover route it replaced, and endo + that route, shared_mul's,
against its phi form where the checkout has it; B = 2 and 16 at 16 lanes,
4 and 16 at 512), complete_square (B = 1 at 16 and 256 lanes, 16 at 16),
select_reduce (both designs), sr_variant
(blk 1,024 / out 128, with and without its selection), select_reduce_fused
at 4,096 and 2^21 lanes, decompress, to_affine, inv, endo, pneg,
normalize3, select_small, assemble and reduce_lanes.  Then, unless ``--quick``, the rows of ``tools.phase_bench``
(throughput and one-warp latency) and of ``tools.r5_experiments``, and
one profiled 64bit prove (``engine_profile.profile_prove``: device ms and
the device's idle share).  Prints the card's ``nvidia-smi`` line, a line a
case, and last ``TURNS {json}``.  It calls the wrappers only through
interfaces older checkouts have too, so a copy of this file (and of
``tools/phase_bench.py``) runs in a ``git archive`` of an earlier commit:
run both checkouts in one call, in turns (parent, change, change, parent),
and compare within it.  Exits 2 without CUDA.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import bounds
from ..bench import sampled
from ..core import ec
from ..core.fields import Q
from ..ops import glv, kernels, limb

ROWS = 33
DEV = "cuda"


def points(n: int, rng):
    """n projective lanes: 64 multiples of G, each lane with its own Z
    (scaled on the card past 4,096 lanes), about 1/8 identity lanes."""
    base = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=64)]
    k = min(n, 4096)
    cols = ([], [], [])
    for _ in range(k):
        if rng.integers(0, 8) == 0:
            coords = (0, int(rng.integers(1, 2**62)), 0)
        else:
            p = base[int(rng.integers(0, 64))]
            z = int(rng.integers(1, 2**62)) * (1 << 190) % Q
            coords = (p[0] * z % Q, p[1] * z % Q, z)
        for c, v in zip(cols, coords):
            c.append(v)
    p = tuple(limb.from_ints(c, DEV) for c in cols)
    if n == k:
        return p
    z = torch.as_tensor(rng.integers(1, 1 << 16, size=(limb.NLIMB, n)), device=DEV)
    return tuple(limb.mul(c.repeat(1, -(-n // k))[:, :n], z) for c in p)


def digits(shape, rng):
    absd = torch.as_tensor(rng.integers(0, 9, size=shape), dtype=torch.uint8, device=DEV)
    sgn = torch.as_tensor(rng.integers(0, 2, size=shape), dtype=torch.uint8, device=DEV)
    return absd, sgn


def fold_digits(B: int, rng):
    """(B, 4, ROWS) fold digits, each prover's own scalars."""
    out = []
    for _ in range(B):
        b, a = (int(v) << 64 for v in rng.integers(1, 2**62, size=2))
        out.append(np.stack([*glv.recode_signed(-b), *glv.recode_signed(a)]))
    return np.stack(out)


def cases(rng) -> dict:
    """{case: a call of one kernel (or of sr_variant's two forms)}."""
    out = {}
    p = points(65536, rng)
    q = points(65536, rng)
    out["padd L=65536 wide"] = lambda: kernels.padd_design(p, q, False)
    n1 = tuple(t[:, :1056].contiguous() for t in p)
    m1 = tuple(t[:, :1056].contiguous() for t in q)
    out["padd L=1056 narrow"] = lambda: kernels.padd(n1, m1)
    p4 = tuple(t[:, :4096].contiguous() for t in p)
    p16 = tuple(t[:, :16].contiguous() for t in p)
    out["table_flat L=4096"] = lambda: kernels.table_flat(p4)
    out["table_flat L=16"] = lambda: kernels.table_flat(p16)
    w1 = points(16896, rng)
    w2 = points(33792, rng)
    out["reduce_block W=16896 f=4"] = lambda: kernels.reduce_block(w1, 4)
    out["reduce_block W=33792 f=8"] = lambda: kernels.reduce_block(w2, 8)
    # one MSM, stacks of 264 and 528 row trees (one and two waves of two
    # 256-thread blocks an SM), and msm_many's widest (4,290 row trees)
    for K in (1, 8, 16, 130):
        tl = tuple(t.reshape(limb.NLIMB, K, ROWS * 128) for t in points(K * ROWS * 128, rng))
        out[f"tail_horner K={K}"] = lambda tl=tl: kernels.tail_horner(tl, ROWS)
    # msm's route at 128 lanes: cli test's commonest, selected from the tables
    tt = kernels.table_flat(points(2 * 128, rng))
    ta, ts = digits((2, ROWS, 128), rng)
    out["tail_horner K=2 tables canonical"] = lambda: kernels.tail_horner(
        tt, ROWS, canonical=True, absd=ta, sgn=ts)
    for K in (1, 130):
        hr = tuple(t.reshape(limb.NLIMB, K, ROWS) for t in points(K * ROWS, rng))
        out[f"horner K={K}"] = lambda hr=hr: kernels.horner(*hr)
    fd = fold_digits(1, rng)
    fe, fo = kernels.table_flat(points(512, rng)), kernels.table_flat(points(512, rng))
    out["fold L=512"] = lambda: kernels.fold(fe, fo, fd[0])
    for B, L in ((1, 16), (1, 512), (1, 4096), (2, 16), (16, 16), (4, 512), (16, 512)):
        pe, po, d = points(B * L, rng), points(B * L, rng), fold_digits(B, rng)
        out[f"fold_many B={B} L={L}"] = lambda pe=pe, po=po, d=d: kernels.fold_many(pe, po, d)
        if B > 1:
            continue
        # the one-prover route before fold_many took it, and shared_mul's
        out[f"table_flat x 2 + fold L={L}"] = lambda pe=pe, po=po, d=d: kernels.fold(
            kernels.table_flat(pe), kernels.table_flat(po), d[0])
        out[f"endo + table_flat x 2 + fold L={L}"] = lambda pe=pe, d=d: kernels.fold(
            kernels.table_flat(pe), kernels.table_flat(kernels.endo(pe)), d[0])
        if hasattr(kernels, "fold_phi"):
            out[f"fold_many phi B=1 L={L}"] = lambda pe=pe, d=d: kernels.fold_phi(pe, d)
    for B, L in ((1, 16), (1, 256), (16, 16)):
        g0, g1, d = points(B * L, rng), points(B * L, rng), fold_digits(B, rng)
        out[f"complete_square B={B} L={L}"] = (
            lambda g0=g0, g1=g1, d=d: kernels.complete_square(g0, g1, d))
    tabs = kernels.table_flat(p)
    ad, sg = digits((ROWS, 65536), rng)
    out["select_reduce L=65536 staged"] = lambda: kernels.select_reduce(tabs, ad[None], sg[None])
    out["select_reduce L=65536 rows"] = (
        lambda: kernels.select_reduce_design(tabs, ad[None], sg[None], False))
    out["sr_variant L=65536 blk=1024 out=128"] = lambda: kernels.sr_variant(tabs, ad, sg)
    out["sr_variant L=65536 blk=1024 out=128 noselect"] = (
        lambda: kernels.sr_variant(tabs, ad, sg, 1024, 128, True))
    t4 = kernels.table_flat(p4)
    a4, s4 = digits((1, ROWS, 4096), rng)
    out["select_reduce L=4096 rows"] = lambda: kernels.select_reduce(t4, a4, s4)
    out["select_reduce_fused L=4096"] = lambda: kernels.select_reduce_fused(p4, a4, s4)
    wide = points(1 << 21, rng)
    aw, sw = digits((1, ROWS, 1 << 21), rng)
    out["select_reduce_fused L=2097152"] = lambda: kernels.select_reduce_fused(wide, aw, sw)
    xs = limb.from_ints([int.from_bytes(rng.bytes(32), "little") % Q for _ in range(16384)], DEV)
    sign = torch.as_tensor(rng.integers(0, 2, size=16384), device=DEV)
    out["decompress L=16384"] = lambda: kernels.decompress(xs, sign)
    out["decompress L=16"] = lambda: kernels.decompress(xs[:, :16].contiguous(), sign[:16])
    out["to_affine L=4096"] = lambda: kernels.to_affine(*p4)
    out["inv L=4096"] = lambda: kernels.inv(p4[2])
    e20 = tuple(t[:, : 1 << 20].contiguous() for t in wide)
    out["endo 2^20 interleaved"] = lambda: kernels.endo(e20, True)
    out["pneg L=16"] = lambda: kernels.pneg(p16)
    out["endo L=16"] = lambda: kernels.endo(p16)
    out["normalize3 K=2"] = lambda: kernels.normalize3(*(t[:, :2].contiguous() for t in p16))
    t32 = kernels.table_flat(tuple(t[:, :32].contiguous() for t in p))
    sa, ss = digits((2, ROWS, 16), rng)
    out["select_small B=2 L=16"] = lambda: kernels.select_small(t32, sa, ss)
    bases = [[[tuple(t[:, 1 + 16 * s:1 + 16 * s + n] for t in p)]] for s, n in ((0, 15), (1, 14))]
    out["assemble S=2 K=1 L=16 (29 lanes in)"] = lambda: kernels.assemble(bases, 16)
    rl = kernels.table_flat(points(64, rng))
    ra, rs = digits((2, ROWS, 32), rng)
    out["reduce_lanes B=2 L=32"] = lambda: kernels.reduce_lanes(rl, ra, rs)
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("kernel_turns: CUDA is not available; the tool runs on the card only", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(prog="kernel_turns")
    ap.add_argument("--label", default="")
    ap.add_argument("--quick", action="store_true", help="the kernel cases only")
    args = ap.parse_args(argv)
    card = bounds.card()
    print(f"{card['name']}, {card['power_limit_w']:.2f} W", flush=True)
    kernels.lib()
    rng = np.random.default_rng(20261018)
    times = {}
    for name, fn in cases(rng).items():
        times[name] = sampled(lambda k: fn())["ms"]
        print(f"{args.label} {name:48s} {times[name]:10.4f} ms", flush=True)
    out = {"label": args.label, "card": card, "ms": times}
    if not args.quick:
        from .. import engine_profile
        from ..ops.engine import TorchEngine
        from . import phase_bench, r5_experiments

        out["phase_bench"] = phase_bench.run()
        out["r5"] = r5_experiments.run()
        prove = engine_profile.profile_prove("64bit", TorchEngine(DEV))
        out["prove_64bit"] = {k: prove[k] for k in ("device_s", "device_idle_share", "wall_s",
                                                    "complete", "proof_sha256")}
        print(f"{args.label} 64bit prove: {json.dumps(out['prove_64bit'])}", flush=True)
    print("TURNS " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
