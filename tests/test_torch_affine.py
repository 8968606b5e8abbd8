"""Device affine conversion: the port's ``limb.inv``, ``limb.batch_inv`` and
``curve.to_affine`` (+ ``affine_lanes_to_host``) against the JAX package's on
the same numpy limb planes, exactly (after ``normalize`` on the JAX side:
the port's are canonical), zeros, Q and saturated limbs among the values;
``bounds.INV_CHAIN`` on Python integers; and ``TorchEngine("cpu")``'s
``fold_bases`` / ``shared_mul`` (``msm.run_fold``, one ``to_affine`` a call,
no host inverse) against ``JaxEngine(host_below=0)`` and ``HostEngine``.

The JAX package is imported inside the tests that compare with it, so the
file's CUDA case also runs where JAX is not installed (the machine with the
card):

    python -m pytest --noconftest -m cuda tests/test_torch_affine.py
"""

import importlib
import random

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch import bounds
from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.fields import Q, R
from bulletproofspp_tpu_torch.ops import curve, kernels, limb
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

# 0, 1, Q (strict, = 0 mod p), Q - 1, values in [Q, 2^256) (strict, not
# canonical) and saturated 0xFFFF runs (tests/test_pallas_forms.py:35-45)
EDGE = [
    0, 1, Q, Q - 1, Q - 2, Q + 1, (1 << 256) - 1, (1 << 256) % Q,
    0xFFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFF,
    int("FFFF" * 8 + "0000" * 8, 16),
    int("FFFF0000" * 8, 16),
    pow(2**200 + 7, 2, Q),
]


def _jax(module: str):
    """A module of the JAX package (the test skips where JAX is missing)."""
    pytest.importorskip("jax")
    return importlib.import_module(f"bulletproofspp_tpu.{module}")


def _values(n: int, seed: int) -> list:
    """EDGE, then numpy-seeded randoms over the full 256-bit range: n in all."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(n - len(EDGE))]
    return (EDGE + rand)[:n]


def _inverses(vals) -> list:
    return [pow(v, -1, Q) if v % Q else 0 for v in vals]


def _as_numpy(t) -> np.ndarray:
    return limb.planes_to_numpy(t)


def test_inv_chain_is_p_minus_2_and_inverts_integers():
    """Each step (s, k) squares s times and multiplies by a^(2^k - 1), which
    an earlier step made: the exponent is p - 2, the result a^-1, 0 -> 0."""
    e = 1
    for s, k in bounds.INV_CHAIN:
        e = (e << s) + ((1 << k) - 1 if k else 0)
    assert e == Q - 2
    assert (bounds.INV_SQUARINGS, bounds.INV_PRODUCTS, bounds.inv_chain()) == (255, 15, 270)
    assert bounds.to_affine_chain() == 271
    for a in _values(40, 3):
        made, r = {1: a % Q}, a % Q  # made[k] = a^(2^k - 1)
        f = 1
        for s, k in bounds.INV_CHAIN:
            r = pow(r, 1 << s, Q)
            f <<= s
            if k:
                r = r * made[k] % Q
                f += (1 << k) - 1
            if (f + 1) & f == 0:
                made[f.bit_length()] = r
        assert r == _inverses([a])[0]


def test_inv_and_to_affine_work_count_the_chain():
    assert bounds.INV == 255 * bounds.FE_SQR + 15 * bounds.FE_MUL
    assert bounds.inv(4096) == (4096 * bounds.INV, 4096 * 2 * 128)
    assert bounds.to_affine(16) == (16 * (bounds.INV + 2 * bounds.FE_MUL), 16 * (5 * 128 + 1))


@pytest.mark.parametrize("n", [16, 40])
def test_inv_equals_the_jax_package(n):
    jlimb = _jax("ops.limb")
    vals = _values(n, n)
    packed = limb.pack_ints(vals)
    got = limb.inv(limb.planes_from_numpy(packed, "cpu"))
    assert np.array_equal(_as_numpy(got), np.asarray(jlimb.normalize(jlimb.inv(packed))))
    assert limb.unpack_ints(got) == _inverses(vals)


@pytest.mark.parametrize("shape,axis", [((24,), -1), ((3, 8), -1), ((3, 8), 1)])
def test_batch_inv_equals_the_jax_package(shape, axis):
    """Zeros (0 and Q) map to zero; along either batch axis the same
    canonical inverses as the JAX package's two associative scans."""
    jlimb = _jax("ops.limb")
    vals = _values(int(np.prod(shape)), 7 + len(shape))
    packed = limb.pack_ints(vals).reshape(16, *shape)
    got = limb.batch_inv(limb.planes_from_numpy(packed, "cpu"), axis)
    want = jlimb.normalize(jlimb.batch_inv(packed, axis % (len(shape) + 1)))
    assert np.array_equal(_as_numpy(got), np.asarray(want))
    assert limb.unpack_ints(got.reshape(16, -1)) == _inverses(vals)
    assert torch.equal(got, kernels.inv_plain(limb.planes_from_numpy(packed, "cpu")))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_batch_inv_refuses_the_limb_axis(device):
    """Axis 0 is refused before the device is looked at: on the CPU and on
    any other device (``meta`` stands in for the card here)."""
    with pytest.raises(ValueError, match="limb axis"):
        limb.batch_inv(torch.ones(16, 2, dtype=torch.int64, device=device), 0)


def _points(n: int, seed: int) -> list:
    """n affine points, every 5th lane (from lane 2) None."""
    rng = random.Random(seed)
    return [None if i % 5 == 2 else ec.scalar_mul(rng.randrange(1, R), ec.G) for i in range(n)]


def test_to_affine_of_doubled_points_equals_the_jax_package():
    """pdbl'd lanes (Z not 1) with None lanes (tests/test_ops_curve_msm.py:49-54)."""
    jcurve = _jax("ops.curve")
    pts = _points(24, 11)
    xn, yn, inf = jcurve.to_affine(jcurve.pdbl(jcurve.from_affine_host(pts)))
    got = curve.to_affine(curve.pdbl(curve.from_affine_host(pts, "cpu")))
    for a, b in zip(got, (xn, yn, inf)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = [None if p is None else ec.dbl(p) for p in pts]
    assert curve.affine_lanes_to_host(*got) == jcurve.affine_lanes_to_host(xn, yn, inf) == want


def test_to_affine_of_edge_lanes_equals_the_jax_package():
    """Raw strict planes: z = 0, Q, Q - 1, x = 0 and saturated limbs among
    the lanes; where z = 0 mod p, x and y are 0 and inf is set."""
    jcurve = _jax("ops.curve")
    xs, ys, zs = _values(40, 21), _values(40, 22)[::-1], _values(40, 23)
    xs[5] = 0
    planes = [limb.pack_ints(v) for v in (xs, ys, zs)]
    want = jcurve.to_affine(tuple(planes))
    got = curve.to_affine(tuple(limb.planes_from_numpy(p, "cpu") for p in planes))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    host = [None if z % Q == 0 else (x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q)
            for x, y, z in zip(xs, ys, zs)]
    assert curve.affine_lanes_to_host(*got) == host
    assert [limb.unpack_ints(c) for c in got[:2]] == [
        [0 if h is None else h[i] for h in host] for i in (0, 1)]


ENGINE = TorchEngine("cpu")


@pytest.mark.parametrize("n", [16, 40])
def test_fold_bases_and_shared_mul_equal_the_jax_and_host_engines(n):
    """None lanes, zero scalars, a negative fold scalar; 40 lanes pad to a
    bucket of 64 (identity lanes in the port, G in the JAX package)."""
    jeng = _jax("ops.engine").JaxEngine(host_below=0)
    host = HostEngine()
    rng = random.Random(n)
    even, odd = _points(n, n), _points(n, 100 + n)
    for b, a in ((rng.randrange(2**127), -rng.randrange(2**127)), (0, rng.randrange(2**127)),
                 (0, 0)):
        got = ENGINE.fold_bases(b, a, even, odd)
        assert got == host.fold_bases(b, a, even, odd) == jeng.fold_bases(b, a, even, odd), (b, a)
    for k in (rng.randrange(R), 0, R - 1):
        got = ENGINE.shared_mul(k, even)
        assert got == host.shared_mul(k, even) == jeng.shared_mul(k, even), k


def test_fold_bases_and_shared_mul_convert_once_on_the_device(monkeypatch):
    """One to_affine a call, on the fold's lanes; no host inverse."""
    calls = []
    inner = kernels.to_affine
    monkeypatch.setattr(kernels, "to_affine",
                        lambda *p: calls.append(p[0].shape) or inner(*p))

    def no_host_inverse(arr):
        raise AssertionError("a lane went through the host inverse")

    monkeypatch.setattr(curve, "affine_from_normalized", no_host_inverse)
    pts = _points(17, 5)
    assert ENGINE.fold_bases(3, 5, pts, pts[::-1]) == HostEngine().fold_bases(3, 5, pts, pts[::-1])
    assert ENGINE.shared_mul(7, pts) == HostEngine().shared_mul(7, pts)
    assert calls == [(16, 32), (16, 32)]


@pytest.mark.cuda
def test_cuda_inv_and_to_affine_match_plain_versions():
    """On the card: both kernels equal their plain versions word for word
    (canonical outputs) on the edge values, limb.batch_inv launches inv,
    and fold_bases / shared_mul equal HostEngine's with one to_affine
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    kernels.reset_counts()
    a = limb.from_ints(_values(512, 1), dev)
    assert torch.equal(kernels.inv(a), kernels.inv_plain(a))
    assert torch.equal(limb.batch_inv(a), limb.batch_inv_plain(a))
    with pytest.raises(ValueError, match="limb axis"):
        limb.batch_inv(a, 0)
    p = tuple(limb.from_ints(_values(512, s), dev) for s in (2, 3, 4))
    for got, want in zip(kernels.to_affine(*p), kernels.to_affine_plain(*p)):
        assert torch.equal(got, want)
    assert (kernels.counts()["inv"], kernels.counts()["to_affine"]) == (2, 1)
    eng, pts = TorchEngine(dev), _points(40, 9)
    assert eng.fold_bases(3, -5, pts, pts[::-1]) == HostEngine().fold_bases(3, -5, pts, pts[::-1])
    assert eng.shared_mul(R - 1, pts) == HostEngine().shared_mul(R - 1, pts)
    assert kernels.counts()["to_affine"] == 3
