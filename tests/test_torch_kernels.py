"""Each CUDA kernel's plain PyTorch version against the Pallas kernel it
replaces, run as tests/test_pallas.py runs it (interpret=True on the CPU),
at small widths.  The CUDA kernels against their plain versions on the
card: tests/test_torch_cuda.py.

The port and the JAX package compute the same RCB formulas in the same
addition order, so their projective outputs agree limb for limb once
normalized mod p: the comparison is exact (integer maths, no tolerance).
Inputs are numpy-seeded points with random projective scaling, identity
lanes, P + P and P + (-P).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bulletproofspp_tpu.core import ec  # noqa: E402
from bulletproofspp_tpu.core.fields import Q  # noqa: E402
from bulletproofspp_tpu.ops import limb as jlimb  # noqa: E402
from bulletproofspp_tpu.ops import pallas_field  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, kernels, limb  # noqa: E402


def _points(n: int, seed: int):
    """(3, 16, n) uint32 numpy planes of projective points: multiples of G
    scaled by random Z, every 7th lane the identity, and host affine list."""
    rng = np.random.default_rng(seed)
    out = [[], [], []]
    pts = []
    for i in range(n):
        if i % 7 == 3:
            coords, pt = (0, int(rng.integers(1, 2**62)), 0), None
        else:
            pt = ec.scalar_mul(int(rng.integers(1, 2**62)), ec.G)
            z = int(rng.integers(1, 2**62)) << 180
            coords = (pt[0] * z % Q, pt[1] * z % Q, z % Q)
        for c, v in zip(out, coords):
            c.append(v)
        pts.append(pt)
    return np.stack([jlimb.pack_ints(c) for c in out]), pts


def _port(arr, shape=None):
    t = tuple(limb.planes_from_numpy(a, "cpu") for a in arr)
    return t if shape is None else tuple(c.reshape(shape) for c in t)


def _jax(arr):
    return tuple(jnp.asarray(a) for a in arr)


def _canon_port(p):
    return limb.planes_to_numpy(curve.normalize3(*p)).reshape(3, 16, -1)


def _canon_jax(p):
    return np.stack([np.asarray(jlimb.normalize(c)) for c in p]).reshape(3, 16, -1)


def test_padd_plain_matches_padd_pallas():
    n = 32
    p, pts = _points(n, 1)
    q, qpts = _points(n, 2)
    # lanes 0-5: P + P (another scaling) and P + (-P)
    for i in range(6):
        k = 3 + i
        vals = [jlimb.unpack_ints(p[c, :, i : i + 1])[0] for c in range(3)]
        if i % 2:
            vals[1] = (Q - vals[1]) % Q
        q[:, :, i] = np.stack([jlimb.pack_int(v * k % Q) for v in vals])
        qpts[i] = pts[i] if i % 2 == 0 else (ec.neg(pts[i]) if pts[i] else None)
    got = kernels.padd_plain(_port(p), _port(q))
    want = pallas_field.padd_pallas(_jax(p), _jax(q), block=n, interpret=True)
    assert np.array_equal(_canon_port(got), _canon_jax(want))
    assert curve.to_affine_host(got) == [ec.add(a, b) for a, b in zip(pts, qpts)]


def test_curve_pdbl_pneg_endo_match_jax():
    from bulletproofspp_tpu.ops import curve as jcurve

    p, pts = _points(16, 6)
    for port_fn, jax_fn, host_fn in (
        (curve.pdbl, jcurve.pdbl, ec.dbl),
        (curve.pneg, jcurve.pneg, lambda q: q and ec.neg(q)),
        (curve.endo, jcurve.endo, lambda q: q and ec.endo(q)),
    ):
        got = port_fn(_port(p))
        assert np.array_equal(_canon_port(got), _canon_jax(jax_fn(_jax(p))))
        assert curve.to_affine_host(got) == [host_fn(q) for q in pts]


def test_padd_wrapper_takes_plain_version_on_cpu():
    p, _ = _points(16, 3)
    q, _ = _points(16, 4)
    kernels.reset_counts()
    got = curve.padd(_port(p), _port(q))
    assert kernels.counts()["padd"] == 0  # no kernel on a CPU tensor
    assert np.array_equal(_canon_port(got), _canon_port(kernels.padd_plain(_port(p), _port(q))))


def test_horner_plain_matches_horner_pallas():
    rows = 5
    r, pts = _points(rows, 5)
    want = pallas_field.horner_pallas(*_jax(r), interpret=True)
    got = kernels.horner_plain(*_port(r, (16, 1, rows)))
    assert np.array_equal(_canon_port(got), _canon_jax(want))
    acc = None
    for pt in pts:
        for _ in range(4):
            acc = ec.dbl(acc)
        acc = ec.add(acc, pt)
    assert curve.to_affine_host(got) == [acc]


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_reduce_block_plain_matches_reduce_block_pallas(factor):
    w = 128 * factor
    p, _ = _points(w, 10 + factor)
    want = pallas_field.reduce_block_pallas(_jax(p), factor=factor, interpret=True)
    got = kernels.reduce_block_plain(_port(p), factor)
    assert np.array_equal(_canon_port(got), _canon_jax(want))


def test_kernel_wrappers_reject_bad_shapes():
    p, _ = _points(16, 30)
    with pytest.raises(ValueError):
        kernels.reduce_block(_port(p), 8)  # 16 lanes: not a multiple of 1024
    with pytest.raises(ValueError):
        kernels.tail_horner(_port(p, (16, 1, 16)), 1)
    digits = torch.zeros((1, 2, 16), dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.select_reduce(kernels.table_flat(_port(p)), digits, digits)  # 16 lanes
