"""The port's MSM, basis fold and square completion (plain path on the CPU)
against the JAX package's kernels on the CPU and the exact host engine.

Inputs come from numpy seeds and reach both packages as the same limb
planes and digit arrays.  MSM outputs are compared as affine points (the
lane trees add in different orders); fold and square completion add in
the same order as the JAX kernels, so their normalized projective lanes
must agree limb for limb.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bulletproofspp_tpu.core import ec  # noqa: E402
from bulletproofspp_tpu.core.engine import HostEngine  # noqa: E402
from bulletproofspp_tpu.core.fields import Q, R  # noqa: E402
from bulletproofspp_tpu.ops import curve as jcurve  # noqa: E402
from bulletproofspp_tpu.ops import limb as jlimb  # noqa: E402
from bulletproofspp_tpu.ops import msm as jmsm  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, glv, limb, msm  # noqa: E402
from bulletproofspp_tpu_torch.ops.engine import TorchEngine  # noqa: E402


def _affine_points(n, rng):
    return [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=n)]


def _planes(pts):
    """(3, 16, n) uint32 numpy planes of affine points (None: identity)."""
    cols = [[], [], []]
    for p in pts:
        for c, v in zip(cols, (0, 1, 0) if p is None else (p[0], p[1], 1)):
            c.append(v)
    return np.stack([jlimb.pack_ints(c) for c in cols])


def _port(arr):
    return tuple(limb.planes_from_numpy(a, "cpu") for a in arr)


def _host_msm_from_digits(pts, absd, sgn):
    total = None
    for i, p in enumerate(pts):
        if p is None:
            continue
        k = 0
        for r in range(absd.shape[0]):
            k = 16 * k + (-1 if sgn[r, i] else 1) * int(absd[r, i])
        total = ec.add(total, ec.scalar_mul(k % R, p))
    return total


def _msm_case(L):
    rng = np.random.default_rng(L)
    pts = _affine_points(min(L, 48), rng)
    pts = [pts[i % len(pts)] if i % 5 else None for i in range(L)]
    absd = rng.integers(0, 9, size=(glv.ROWS, L)).astype(np.uint32)
    sgn = rng.integers(0, 2, size=(glv.ROWS, L)).astype(np.uint32)
    arr = _planes(pts)
    px, py, pz = (t.unsqueeze(1) for t in _port(arr))
    got = msm.msm(px, py, pz, torch.as_tensor(absd[None], dtype=torch.int64),
                  torch.as_tensor(sgn[None], dtype=torch.int64))
    return pts, arr, absd, sgn, curve.to_affine_host(got)[0]


@pytest.mark.parametrize("L", [16, 64, 128, 512, 1024])
def test_msm_bucket_matches_host(L):
    """Under 128 lanes the lane tree + horner path, from 128 the
    reduce_block chain + tail_horner path, from 1,024 select_reduce
    first."""
    pts, _, absd, sgn, got = _msm_case(L)
    assert got == _host_msm_from_digits(pts, absd, sgn)


# The JAX package's run_msm compiles for 75-170 s per bucket above 16
# lanes on the XLA CPU backend, so only bucket 16 runs by default.
@pytest.mark.parametrize(
    "L", [16] + [pytest.param(L, marks=pytest.mark.slow) for L in (64, 128, 512)]
)
def test_msm_bucket_matches_jax_run_msm(L):
    _, arr, absd, sgn, got = _msm_case(L)
    want = jcurve.to_affine_host(
        jmsm.run_msm(*(jnp.asarray(a) for a in arr), jnp.asarray(absd), jnp.asarray(sgn))
    )[0]
    assert got == want


def test_msm_batch_of_entries_matches_single_entries():
    """msm_many's stacked layout: B entries in one call equal B calls."""
    rng = np.random.default_rng(7)
    B, L = 3, 16
    pts = _affine_points(L, rng)
    arr = _planes(pts)
    absd = torch.as_tensor(rng.integers(0, 9, size=(B, glv.ROWS, L)))
    sgn = torch.as_tensor(rng.integers(0, 2, size=(B, glv.ROWS, L)))
    px, py, pz = (t.unsqueeze(1).expand(16, B, L).contiguous() for t in _port(arr))
    got = curve.to_affine_host(msm.msm(px, py, pz, absd, sgn))
    for b in range(B):
        one = msm.msm(px[:, :1], py[:, :1], pz[:, :1], absd[b : b + 1], sgn[b : b + 1])
        assert curve.to_affine_host(one)[0] == got[b]


def _fold_inputs(seed, n=16):
    rng = np.random.default_rng(seed)
    even = _affine_points(n, rng)
    odd = _affine_points(n - 3, rng) + [None] * 3
    b = -int(rng.integers(1, 2**62)) * (1 << 64) - 12345
    a = int(rng.integers(1, 2**62)) << 60
    return even, odd, b, a


def _canon_port(p):
    return limb.planes_to_numpy(curve.normalize3(*p))


def _canon_jax(p):
    return np.stack([np.asarray(jlimb.normalize(c)) for c in p])


def test_fold_mul_matches_jax_kernel_and_host():
    even, odd, b, a = _fold_inputs(11)
    ae, ao = _planes(even), _planes(odd)
    de, se = glv.recode_signed(b)
    do, so = glv.recode_signed(a)
    got = msm.fold_mul(_port(ae), _port(ao), de, se, do, so)
    want = jmsm.fold_mul_kernel(
        *(jnp.asarray(x) for x in (*ae, *ao, de, se, do, so))
    )
    assert np.array_equal(_canon_port(got), _canon_jax(want))
    assert curve.to_affine_host(got) == [ec.double_base_mul(b, e, a, o) for e, o in zip(even, odd)]


def test_complete_square_matches_jax_kernel_and_host():
    g0, g1, _, _ = _fold_inputs(12)
    r = int(np.random.default_rng(13).integers(1, 2**62)) ** 4 % R
    k1, k2 = glv.split(r)
    de, se = glv.recode_signed(k1)
    do, so = glv.recode_signed(k2)
    a0, a1 = _planes(g0), _planes(g1)
    gx, hy = msm.complete_square(_port(a0), _port(a1), de, se, do, so)
    j0 = tuple(jnp.asarray(x) for x in a0)
    want = jmsm.complete_square_kernel(
        *j0, *jcurve.endo(j0), *(jnp.asarray(x) for x in (*a1, de, se, do, so))
    )
    assert np.array_equal(_canon_port(gx), _canon_jax(want[:3]))
    assert np.array_equal(_canon_port(hy), _canon_jax(want[3:]))
    host_gx, host_hy = HostEngine().complete_square(r, g0, g1)
    assert curve.to_affine_host(gx) == host_gx
    assert curve.to_affine_host(hy) == host_hy


def test_engine_calls_match_host_engine():
    rng = np.random.default_rng(21)
    eng, host = TorchEngine("cpu"), HostEngine()
    pts = _affine_points(10, rng) + [None]
    scal = [int(s) for s in rng.integers(0, 2**62, size=len(pts))] + [R - 1]
    pairs = list(zip(scal, pts + [ec.G]))
    assert eng.msm(pairs) == host.msm(pairs)
    assert eng.msm([]) is None and eng.msm([(3, pts[0]), (R - 3, pts[0])]) is None
    groups = [(scal[:4], pts[:4]), (scal[4:7], pts[4:7])]
    assert eng.msm_many([groups, [], groups[:1]]) == host.msm_many([groups, [], groups[:1]])
    xs = [p[0] for p in pts[:6]] + [5]  # x = 5: x^3 + 7 is not a residue
    signs = [i % 2 == 0 for i in range(7)]
    assert eng.decompress(xs, signs) == host.decompress(xs, signs)
    even, odd = eng.bv_split(eng.basevec(pts))
    assert [len(even), len(odd)] == [6, 6]
    assert even.to_host() == pts[0::2] and odd.to_host() == pts[1::2] + [None]
    assert eng.fold_bv(7, -9, even, odd).to_host() == host.fold_bv(7, -9, pts[0::2], pts[1::2] + [None])
    mixed = [17, 18, ec.G[0], Q + 5]  # 17, 18, Q + 5: off the curve
    assert eng.decompress(mixed, [True] * 4) == host.decompress(mixed, [True] * 4)


def test_basevec_cache_is_bounded_and_device_points_from_numpy():
    from bulletproofspp_tpu_torch.ops.engine import BV_CACHE_MAX, DevicePoints

    eng = TorchEngine("cpu")
    bases = [[ec.G] for _ in range(BV_CACHE_MAX + 5)]
    for b in bases:
        eng.basevec_cached(b)
    assert len(eng._bv_cache) == BV_CACHE_MAX
    assert eng.basevec_cached(bases[-1]) is eng.basevec_cached(bases[-1])
    assert eng.basevec_cached(ec.G).to_host() == [ec.G]
    dp = DevicePoints.from_numpy(*_planes([ec.G, None]), "cpu")
    assert dp.to_host() == [ec.G, None] and len(dp) == 2
