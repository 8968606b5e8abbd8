"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, prove, verify.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. print the card (``nvidia-smi`` name and power limit) and build the
     CUDA kernels from ``bulletproofspp_tpu_torch/csrc`` with nvcc;
  2. hold each kernel (padd, horner, reduce_block, tail_horner,
     table_flat, select_reduce, fold) against its plain PyTorch version
     on the card, at
     the shapes the main path gives it, on numpy-seeded points (identity
     lanes, P + P and P + (-P) included): the normalized projective
     outputs must be equal limb for limb; time both;
  3. reset the launch counts and run the port's CLI ``test`` command
     (prove, verify, encode, decode, verify) on examples/64bit and
     examples/128by64: rc 0 and proof/commitment bytes equal to the
     golden digests of tests/test_golden.py;
  4. require that every kernel was launched during phase 3 and that no
     JAX module was imported;
  5. time ``prove`` and ``verify`` per example through the same CLI and
     check that a proof with one flipped byte is rejected (rc 1).

The line before the last is one JSON object with each kernel's launch
count (phase 3), largest normalized difference and times; the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
CUDA is not available.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
ROWS = 33

GOLDEN = {  # tests/test_golden.py:45-46 and :57-58 (proof, commitments)
    "64bit": ("fe39faef84b016b82b017a4ef07ba3f31c5237b0f79c0653376c86f5dbba8c5d",
              "fd56b4b18729678d4f77a64644771f77ebaf38f686da8523a3fdebcb2d29c8ee"),
    "128by64": ("c6f5f7cfaaa839c72fc9b7953c261019bf15f015b7de0e35c16a3393493c50f1",
                "97ed392017a230f3b1278a095764a7859559be22d5f603f41907d1a6658acdbf"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_points(n: int, rng, dev):
    """n projective lanes on ``dev``: multiples of G with random Z scaling,
    about 1/8 identity lanes.  Returns the planes and the host affine list."""
    from bulletproofspp_tpu.core import ec
    from bulletproofspp_tpu.core.fields import Q
    from bulletproofspp_tpu_torch.ops import limb

    base = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=64)]
    xs, ys, zs, pts = [], [], [], []
    for i in range(n):
        if rng.integers(0, 8) == 0:
            z = int(rng.integers(1, 2**62))
            xs.append(0), ys.append(z), zs.append(0), pts.append(None)
            continue
        p = base[int(rng.integers(0, len(base)))]
        z = int(rng.integers(1, 2**62)) * (1 << 190) % Q
        xs.append(p[0] * z % Q), ys.append(p[1] * z % Q), zs.append(z), pts.append(p)
    return tuple(limb.from_ints(v, dev) for v in (xs, ys, zs)), pts


def rescale_and_negate(p, rng, negate_mask):
    """Another projective representative of the same lanes (Z scaled), with
    Y negated where ``negate_mask``: for P + P and P + (-P) lanes."""
    from bulletproofspp_tpu.core.fields import Q
    from bulletproofspp_tpu_torch.ops import limb

    n = p[0].shape[-1]
    xs, ys, zs = (limb.unpack_ints(c) for c in p)
    ks = [int(k) for k in rng.integers(1, 2**62, size=n)]
    out = ([], [], [])
    for i in range(n):
        y = (Q - ys[i]) % Q if negate_mask[i] else ys[i]
        for c, v in zip(out, (xs[i], y, zs[i])):
            c.append(v * ks[i] % Q)
    return tuple(limb.from_ints(v, p[0].device) for v in out)


def compare(name, kernel_out, plain_out):
    """Largest difference of the normalized outputs (points or flat
    tables); raises unless it is 0."""
    from bulletproofspp_tpu_torch.ops import limb

    def canon(ts):
        return torch.cat([limb.normalize(t.reshape(-1, limb.NLIMB, t.shape[-1]).transpose(0, 1))
                          .reshape(limb.NLIMB, -1) for t in ts], 1)

    a, b = canon(kernel_out), canon(plain_out)
    err = int((a - b).abs().max().item())
    if err != 0:
        raise AssertionError(f"kernel {name} disagrees with its plain version: max |diff| {err}")
    return err


def check_kernels(dev):
    """Phase 2: each kernel against its plain version at the main path's shapes."""
    from bulletproofspp_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED)
    rows = []

    # padd: table builds and lane trees, L = 128 ... 4096
    for L in (128, 1024, 4096):
        p, _ = random_points(L, rng, dev)
        mode = rng.integers(0, 3, size=L)  # 0: P + Q, 1: P + P, 2: P + (-P)
        q_other, _ = random_points(L, rng, dev)
        q_same = rescale_and_negate(p, rng, mode == 2)
        sel = torch.as_tensor(mode == 0, device=dev)
        q = tuple(torch.where(sel, a, b) for a, b in zip(q_other, q_same))
        err = compare(f"padd L={L}", kernels.padd(p, q), kernels.padd_plain(p, q))
        if L == 4096:
            rows.append(("padd", err, time_ms(lambda: kernels.padd(p, q), 20),
                         time_ms(lambda: kernels.padd_plain(p, q), 3), f"L={L}"))

    # horner: (16, K, 33) row sums for K stacked MSMs (msm_many: K up to 130)
    for K in (1, 130):
        r, _ = random_points(K * ROWS, rng, dev)
        r = tuple(c.reshape(16, K, ROWS) for c in r)
        err = compare(f"horner K={K}", kernels.horner(*r), kernels.horner_plain(*r))
    rows.append(("horner", err, time_ms(lambda: kernels.horner(*r), 5),
                 time_ms(lambda: kernels.horner_plain(*r), 1), f"K={K} rows={ROWS}"))

    # reduce_block: factors 2/4/8 at W = 33 * 1024 (a 1,024-lane MSM's rows)
    w = ROWS * 1024
    p, _ = random_points(w, rng, dev)
    for f in (2, 4, 8):
        err = compare(f"reduce_block f={f}", kernels.reduce_block(p, f),
                      kernels.reduce_block_plain(p, f))
    rows.append(("reduce_block", err, time_ms(lambda: kernels.reduce_block(p, 8), 10),
                 time_ms(lambda: kernels.reduce_block_plain(p, 8), 2), f"W={w} f=8"))

    # tail_horner: (16, K, 33 * 128)
    for K in (1, 3):
        p, _ = random_points(K * ROWS * 128, rng, dev)
        p = tuple(c.reshape(16, K, ROWS * 128) for c in p)
        err = compare(f"tail_horner K={K}", kernels.tail_horner(p, ROWS),
                      kernels.tail_horner_plain(p, ROWS))
    p1 = tuple(c[:, :1].contiguous() for c in p)
    rows.append(("tail_horner", err, time_ms(lambda: kernels.tail_horner(p1, ROWS), 5),
                 time_ms(lambda: kernels.tail_horner_plain(p1, ROWS), 1), f"K=1 rows={ROWS}"))
    # table_flat and select_reduce: a 4,096-lane MSM (128by64's widest), 33 rows
    from bulletproofspp_tpu_torch.ops import glv

    L = 4096
    p, _ = random_points(L, rng, dev)
    tabs = kernels.table_flat(p)
    err = compare(f"table_flat L={L}", tabs, kernels.table_flat_plain(p))
    rows.append(("table_flat", err, time_ms(lambda: kernels.table_flat(p), 20),
                 time_ms(lambda: kernels.table_flat_plain(p), 2), f"L={L}"))
    absd = torch.as_tensor(rng.integers(0, 9, size=(1, ROWS, L)), device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(1, ROWS, L)), device=dev)
    err = compare(f"select_reduce L={L}", kernels.select_reduce(tabs, absd, sgn),
                  kernels.select_reduce_plain(tabs, absd, sgn))
    rows.append(("select_reduce", err, time_ms(lambda: kernels.select_reduce(tabs, absd, sgn), 10),
                 time_ms(lambda: kernels.select_reduce_plain(tabs, absd, sgn), 2),
                 f"L={L} rows={ROWS}"))

    # fold: per-lane b E + a O with shared digits, L = 512 (128by64's widest)
    e = kernels.table_flat(random_points(512, rng, dev)[0])
    o = kernels.table_flat(random_points(512, rng, dev)[0])
    b, a = (int(v) << 64 for v in rng.integers(1, 2**62, size=2))
    digits = np.stack([*glv.recode_signed(-b), *glv.recode_signed(a)])
    err = compare("fold L=512", kernels.fold(e, o, digits), kernels.fold_plain(e, o, digits))
    rows.append(("fold", err, time_ms(lambda: kernels.fold(e, o, digits), 5),
                 time_ms(lambda: kernels.fold_plain(e, o, digits), 1), "L=512 rows=33"))
    torch.cuda.synchronize()
    for name, err, ms, plain_ms, shape in rows:
        log(f"kernel {name:13s} {shape:18s} max_abs_err {err}  cuda {ms:.4f} ms  plain {plain_ms:.4f} ms")
    return {name: (err, ms, plain_ms) for name, err, ms, plain_ms, _ in rows}


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_cli(args) -> int:
    from bulletproofspp_tpu_torch import cli

    rc = cli.main(list(args) + ["--device", "cuda"])
    torch.cuda.synchronize()
    return rc


def main_path(work):
    """Phase 3: the CLI's test command on each example, golden bytes."""
    secs = {}
    for name, (want_proof, want_coms) in GOLDEN.items():
        d = os.path.join(work, name)
        os.makedirs(d)
        for f in ("schema.json", "witness.json"):
            shutil.copy(os.path.join(HERE, "examples", name, f), d)
        os.chdir(d)
        t0 = time.perf_counter()
        rc = run_cli(["test", "schema.json", "witness.json", "commits.bin", "proof.bin"])
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: cli test rc {rc}")
        if (sha("proof.bin"), sha("commits.bin")) != (want_proof, want_coms):
            raise AssertionError(f"{name}: proof/commitment bytes differ from the golden digests")
        log(f"main path {name}: cli test rc 0, golden bytes, {secs[name]:.3f} s")
    os.chdir(work)
    return secs


def prove_verify_times(work):
    """Phase 5: prove and verify seconds per example; a flipped byte fails."""
    for name, (want_proof, _) in GOLDEN.items():
        os.chdir(os.path.join(work, name))
        t0 = time.perf_counter()
        rc = run_cli(["prove", "schema.json", "witness.json", "c2.bin", "p2.bin"])
        t_prove = time.perf_counter() - t0
        if rc != 0 or sha("p2.bin") != want_proof:
            raise AssertionError(f"{name}: prove rc {rc} or bytes differ")
        t0 = time.perf_counter()
        rc = run_cli(["verify", "schema.json", "c2.bin", "p2.bin"])
        t_verify = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: verify rc {rc}")
        bad = bytearray(open("p2.bin", "rb").read())
        bad[31] ^= 1
        with open("bad.bin", "wb") as f:
            f.write(bytes(bad))
        rc = run_cli(["verify", "schema.json", "c2.bin", "bad.bin"])
        if rc != 1:
            raise AssertionError(f"{name}: tampered proof gave rc {rc}, want 1")
        log(f"{name}: prove {t_prove:.3f} s, verify {t_verify:.3f} s, tampered proof rejected (rc 1)")
    os.chdir(work)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from bulletproofspp_tpu_torch import native
    from bulletproofspp_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    kernels.lib()
    log(f"kernel build + load: {kernels.build_seconds():.3f} s")
    log(f"scalar pipeline: {native.pipeline()}")

    checked = check_kernels(dev)

    work = tempfile.mkdtemp(prefix="bppp_smoke_")
    try:
        kernels.reset_counts()
        main_path(work)
        launches = kernels.counts()
        log(f"launches on the main path: {launches}")
        idle = [k for k, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"kernels never launched on the main path: {idle}")
        if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
            raise AssertionError("JAX was imported")
        prove_verify_times(work)
    finally:
        os.chdir(HERE)
        shutil.rmtree(work, ignore_errors=True)

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "bulletproofspp_tpu_torch/csrc/kernels.cu",
            "replaces": k.replaces,
            "launches": launches[name],
            "max_abs_err": checked[name][0],
            "ms": checked[name][1],
            "plain_ms": checked[name][2],
        }
        for name, k in kernels.KERNELS.items()
    ]}
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
