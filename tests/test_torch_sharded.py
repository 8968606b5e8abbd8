"""The port's sharded MSM (``ops/sharded.py``) and ``ShardedTorchEngine``
on a mesh of 8 ``cpu`` entries (the JAX tests' 8 virtual CPU devices),
against the JAX package's mesh helpers, the port's single-device MSM and
exact host integers (the JAX package's sharded MSM: test_torch_dist.py);
and both dry runs, the one over two gloo processes of one ``cpu`` entry
each.

Inputs come from numpy seeds.  MSM results are compared as affine points:
the shards add in another order than one device does.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bulletproofspp_tpu.core import ec as jec  # noqa: E402
from bulletproofspp_tpu.ops import sharded as jsharded  # noqa: E402
from bulletproofspp_tpu_torch import dryrun  # noqa: E402
from bulletproofspp_tpu_torch.core import ec  # noqa: E402
from bulletproofspp_tpu_torch.core.engine import HostEngine  # noqa: E402
from bulletproofspp_tpu_torch.core.fields import R  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, glv, msm, sharded  # noqa: E402
from bulletproofspp_tpu_torch.ops import dist as tdist  # noqa: E402
from bulletproofspp_tpu_torch.ops.engine import ShardedTorchEngine, _bucket  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n,win", [(8, 1), (8, 2), (8, 4), (8, 8), (4, 2), (2, 2)])
def test_make_mesh_shape_and_order_match_the_jax_package(n, win):
    """(win, pts) shape and the process-major order of the entries: device
    i of the list at the same grid place as JAX's device i."""
    port = sharded.make_mesh([f"cuda:{i}" for i in range(n)], win)  # descriptors, no card
    ref = jsharded.make_mesh(jax.devices()[:n], win)
    assert port.shape == dict(ref.shape)
    assert [[d.index for d in row] for row in port.devices] == [[d.id for d in row]
                                                                for row in ref.devices]


@pytest.mark.parametrize("n,win,words", [(8, 3, "not divisible"), (6, 2, "power of two"),
                                         (6, 1, "power of two")])
def test_make_mesh_errors_match_the_jax_package(n, win, words):
    with pytest.raises(ValueError, match=words):
        jsharded.make_mesh(jax.devices()[:n], win)
    with pytest.raises(ValueError, match=words):
        sharded.make_mesh(["cpu"] * n, win)


@pytest.mark.parametrize("rows", [33, 8])
@pytest.mark.parametrize("win", [1, 2, 3, 4, 8])
def test_pad_rows_matches_the_jax_package(rows, win):
    rng = np.random.default_rng(rows * 10 + win)
    absd = rng.integers(0, 9, size=(rows, 24)).astype(np.uint32)
    sgn = rng.integers(0, 2, size=(rows, 24)).astype(np.uint32)
    want = jsharded.pad_rows(jnp.asarray(absd), jnp.asarray(sgn), win)
    got = sharded.pad_rows(torch.as_tensor(absd[None].astype(np.uint8)),
                           torch.as_tensor(sgn[None].astype(np.uint8)), win)
    for g, w in zip(got, want):
        assert g.shape[1] % win == 0
        assert np.array_equal(g[0].numpy(), np.asarray(w))


def _lanes(n_points, seed):
    """n points (point 1 None, an identity lane pair) and scalars (scalar 2
    zero) as GLV lanes: affine points, (16, 1, 2n) planes and (1, ROWS, 2n)
    digits."""
    rng = np.random.default_rng(seed)
    pts = [jec.scalar_mul(int(k), jec.G) for k in rng.integers(1, 2**62, size=n_points)]
    pts[1] = None
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n_points)]
    scalars[2] = 0
    halves, lane_pts = [], []
    for s, p in zip(scalars, pts):
        halves += glv.split(s)
        lane_pts += [p, None if p is None else (ec.BETA * p[0] % ec.P, p[1])]
    absd, sgn = (torch.as_tensor(d.astype(np.uint8))[None] for d in glv.recode_batch(halves))
    planes = tuple(c.unsqueeze(1) for c in curve.from_affine_host(lane_pts, "cpu"))
    return scalars, pts, planes, absd, sgn


@pytest.fixture(scope="module")
def cases():
    out = {}
    for n in (16, 128):
        scalars, pts, planes, absd, sgn = _lanes(n, n)
        single = curve.to_affine_host(msm.msm(*planes, absd, sgn))[0]
        out[n] = (planes, absd, sgn, single, jec.msm_host(scalars, pts))
    return out


@pytest.mark.parametrize("n_points", [16, 128])
@pytest.mark.parametrize("win", [1, 2, 4, 8])
def test_sharded_msm_equals_one_device_and_host_integers(cases, n_points, win):
    planes, absd, sgn, single, host = cases[n_points]
    assert single == host
    mesh = sharded.make_mesh(CPU8, win)
    absd, sgn = sharded.pad_rows(absd, sgn, win)
    assert curve.to_affine_host(sharded.sharded_msm(mesh, *planes, absd, sgn)) == [host]


def test_shard_sizes_refuse_rows_or_lanes_that_do_not_split():
    mesh = sharded.make_mesh(CPU8, 2)  # 2 x 4
    with pytest.raises(ValueError, match="rows"):
        sharded.shard_sizes(mesh, torch.zeros(1, 33, 32))
    with pytest.raises(ValueError, match="lanes"):
        sharded.shard_sizes(mesh, torch.zeros(1, 34, 24))  # 6 a shard


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    pts = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=n)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    pts[3], scalars[5], scalars[6] = None, 0, R  # an identity lane, two zero scalars
    return list(zip(scalars, pts))


@pytest.mark.parametrize("n_pairs,sharded_call", [(20, False), (31, False), (32, True), (90, True)])
@pytest.mark.parametrize("win", [1, 2, 8])
def test_sharded_engine_msm_equals_host_engine(monkeypatch, n_pairs, sharded_call, win):
    """Under shard_above = 64 lanes (2 a nonzero pair) TorchEngine's path,
    from there the mesh's; zero scalars and None points filtered first."""
    calls = []
    run = sharded.sharded_msm
    monkeypatch.setattr(sharded, "sharded_msm", lambda *a: calls.append(a) or run(*a))
    eng = ShardedTorchEngine("cpu", sharded.make_mesh(CPU8, win), shard_above=64)
    pairs = _pairs(n_pairs + 3, n_pairs)  # 3 pairs are filtered out
    assert eng.msm(pairs) == HostEngine().msm(pairs)
    assert len(calls) == sharded_call
    if sharded_call:  # lanes padded to max(bucket, 16 x npts), rows to a multiple of win
        _, px, _, _, absd, _ = calls[0]
        assert px.shape[2] == max(_bucket(2 * n_pairs), 16 * (8 // win))
        assert absd.shape[1] == -(-glv.ROWS // win) * win
    assert eng.msm([(0, ec.G), (5, None)]) is None


def test_sharded_engine_default_mesh_and_inherited_calls():
    eng = ShardedTorchEngine("cpu", shard_above=0)
    assert eng.mesh.shape == {"win": 1, "pts": 1}
    pts = [ec.scalar_mul(k, ec.G) for k in (3, 5, 7)]
    assert eng.msm(list(zip((1, 2, 3), pts))) == ec.scalar_mul(3 + 10 + 21, ec.G)
    assert eng.fold_bases(2, 3, pts, pts) == HostEngine().fold_bases(2, 3, pts, pts)


def test_sharded_engine_constructor_errors(monkeypatch):
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="power of two"):
        ShardedTorchEngine("cpu", sharded.Mesh(((cpu,) * 3,), ((0,) * 3,)))
    with pytest.raises(ValueError, match="holds no entry"):
        ShardedTorchEngine("cpu", sharded.make_mesh(CPU8, 2, ranks=[1] * 8))
    # a multi-process run (2 ranks) refuses a mesh that leaves a rank out,
    # or that is not process-major
    monkeypatch.setattr(tdist, "is_multiprocess", lambda: True)
    monkeypatch.setattr(tdist.dist, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="global_mesh"):
        ShardedTorchEngine("cpu", sharded.make_mesh(CPU8, 2))
    with pytest.raises(ValueError, match="global_mesh"):
        ShardedTorchEngine("cpu", sharded.make_mesh(CPU8, 2, ranks=[0, 1] * 4))
    eng = ShardedTorchEngine("cpu", sharded.make_mesh(CPU8, 2, ranks=[0] * 4 + [1] * 4))
    assert eng.mesh.span() == {0, 1}


def test_sharded_batch_verify_accepts_and_rejects_a_flipped_byte(monkeypatch):
    """4 HostEngine-proven 32-bit proofs through ShardedTorchEngine on a 2 x
    4 mesh; the merged zero-check MSM runs on the mesh in both batches."""
    calls = []
    run = sharded.sharded_msm
    monkeypatch.setattr(sharded, "sharded_msm", lambda *a: calls.append(a[0]) or run(*a))
    spec_obj, blobs = dryrun._batch_corpus(4)
    eng = ShardedTorchEngine("cpu", sharded.make_mesh(CPU8, 2), shard_above=64)
    assert dryrun._verify_corpus(spec_obj, blobs, 1, eng) == (True, False)
    assert len(calls) == 2


def test_dryrun_multichip_on_cpu_entries():
    dryrun.dryrun_multichip(8, "cpu")


def test_two_gloo_processes_run_the_msm_and_the_batch(monkeypatch):
    """dryrun_multiprocess over 2 gloo processes of one cpu entry each: the
    MSM at win 2 (the window axis across the processes) and win 1 (the
    point axis across them), then 64 proofs batch-verified over the
    2-process mesh, accepted and rejected with one flipped; every rank
    gathers and gets the same results."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    msm_runs, batch_runs = dryrun.dryrun_multiprocess(2, protocol=True, device="cpu")
    want = dryrun.msm_case(64, 99)[1]
    for rank, runs in enumerate(msm_runs):
        assert [(r["win"], r["result"]) for r in runs] == [(w, [str(c) for c in want])
                                                           for w in (2, 1)]
        assert all(r["gathers"] == 1 and r["device"] == "cpu" for r in runs)
    for runs in batch_runs:
        (run,) = runs
        assert (run["proofs"], run["bad"], run["result"]) == (64, 32, [True, False])
        assert run["gathers"] == 2  # the merged MSM of each batch crossed the processes
