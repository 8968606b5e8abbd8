"""The port's multi-process runtime (``ops/dist.py``) on the CPU: its
import, its entry, a failing rank of a gloo process group, and the
single-process branch against the JAX package's ``dist.sharded_msm_global``
on its 8 virtual CPU devices (the dry run over two gloo processes:
test_torch_sharded.py)."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from bulletproofspp_tpu.ops import curve as jcurve  # noqa: E402
from bulletproofspp_tpu.ops import dist as jdist  # noqa: E402
from bulletproofspp_tpu.ops import sharded as jsharded  # noqa: E402
from bulletproofspp_tpu.ops.engine import _msm_lanes  # noqa: E402
from bulletproofspp_tpu_torch import dryrun  # noqa: E402
from bulletproofspp_tpu_torch.core import ec  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, dist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_importing_dist_starts_no_process_group():
    code = ("import torch, bulletproofspp_tpu_torch.ops.dist, bulletproofspp_tpu_torch.dryrun\n"
            "print(torch.distributed.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, check=True)
    assert out.stdout.strip() == "False"


def test_initialize_from_env_is_a_noop_without_the_variables(monkeypatch):
    monkeypatch.delenv("BPPP_COORDINATOR", raising=False)
    assert dist.initialize_from_env() is False
    assert dist.is_multiprocess() is False
    assert not torch.distributed.is_initialized()


def test_global_mesh_in_one_process():
    mesh = dist.global_mesh(2, ["cpu"] * 8)
    assert mesh.shape == {"win": 2, "pts": 4} and mesh.span() == {0}
    dist.require_global(mesh)


def test_sharded_msm_global_equals_the_jax_package():
    """The single-process branch of both packages' ``sharded_msm_global``
    at win = 2 over 8 entries, on the JAX worker's inputs (32 multiples of
    G, ``tests/test_dist.py``): the same point as host integers.  The JAX
    side's XLA compile takes ~35 s here."""
    rng = np.random.default_rng(3)
    scalars = [int(s) for s in rng.integers(1, 2**62, size=32)]
    absd, sgn, lanes_pts = _msm_lanes([(s, ec.G) for s in scalars])
    jplanes = [np.asarray(t) for t in jcurve.from_affine_host(lanes_pts)]
    ja, js = (np.asarray(t) for t in jsharded.pad_rows(absd, sgn, 2))
    ref = jdist.sharded_msm_global(jdist.global_mesh(win=2), *jplanes, ja, js)
    want = [ec.scalar_mul(sum(scalars) % ec.R, ec.G)]
    assert jcurve.to_affine_host(tuple(np.asarray(c).reshape(16, 1) for c in ref)) == want

    planes = (torch.as_tensor(p.astype(np.int64)).unsqueeze(1) for p in jplanes)
    digits = (torch.as_tensor(d.astype(np.uint8))[None] for d in (ja, js))
    got = dist.sharded_msm_global(dist.global_mesh(2, ["cpu"] * 8), *planes, *digits)
    assert curve.to_affine_host(got) == want


def test_a_failing_rank_fails_the_run(tmp_path, monkeypatch):
    """Both ranks fail (a missing corpus); whichever exits first is named,
    with its rc 1, as the first to fail."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(AssertionError, match=r"failed: rank [01] rc 1 \(first to fail\)"):
        dryrun._run_workers(2, ["batch", str(tmp_path / "missing.pkl"), "--device", "cpu"])


def test_the_reaper_kills_the_survivors_of_the_first_failure():
    """Rank 1 fails at once, rank 0 would sleep for a minute: rank 1 is the
    first to fail, rank 0 is killed after it, and each one's output is in
    the message."""
    cmds = [[sys.executable, "-c", "import time; print('rank 0 up', flush=True); time.sleep(60)"],
            [sys.executable, "-c", "import sys; print('rank 1 gives up'); sys.exit(1)"]]
    t0 = time.perf_counter()
    with pytest.raises(AssertionError) as err:
        dryrun._spawn_and_reap(cmds)
    assert time.perf_counter() - t0 < 30
    msg = str(err.value)
    assert msg.startswith("multiprocess worker(s) failed: "
                          "rank 1 rc 1 (first to fail)\nrank 1 gives up")
    assert "rank 0 rc -9 (killed after rank 1 failed)" in msg
    assert msg.index("rank 1 rc 1") < msg.index("rank 0 rc -9")


def test_the_reaper_returns_every_output_when_all_succeed():
    cmds = [[sys.executable, "-c", f"print('rank {i}')"] for i in range(3)]
    assert [out for out, _ in dryrun._spawn_and_reap(cmds)] == [f"rank {i}\n" for i in range(3)]
