"""Each CUDA kernel against its plain PyTorch version on the card, at small
shapes (chip_smoke.py runs the same comparison at the main path's shapes).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX).  Without a
card the test skips.  Exact comparison of normalized projective outputs.
"""

import numpy as np
import pytest
import torch

from bulletproofspp_tpu.core import ec
from bulletproofspp_tpu.core.fields import Q
from bulletproofspp_tpu_torch.ops import curve, glv, kernels, limb


def _points(n: int, seed: int, dev, shape=None):
    """n projective lanes on ``dev``: multiples of G scaled by random Z,
    every 7th lane the identity."""
    rng = np.random.default_rng(seed)
    cols = ([], [], [])
    for i in range(n):
        if i % 7 == 3:
            coords = (0, int(rng.integers(1, 2**62)), 0)
        else:
            pt = ec.scalar_mul(int(rng.integers(1, 2**62)), ec.G)
            z = (int(rng.integers(1, 2**62)) << 180) % Q
            coords = (pt[0] * z % Q, pt[1] * z % Q, z)
        for c, v in zip(cols, coords):
            c.append(v)
    out = tuple(limb.from_ints(c, dev) for c in cols)
    return out if shape is None else tuple(c.reshape(shape) for c in out)


def _same(a, b):
    return torch.equal(curve.normalize3(*a), curve.normalize3(*b))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    kernels.reset_counts()
    p, q = _points(256, 40, dev), _points(256, 41, dev)
    assert _same(kernels.padd(p, q), kernels.padd_plain(p, q))
    r = _points(2 * 33, 42, dev, (16, 2, 33))
    assert _same(kernels.horner(*r), kernels.horner_plain(*r))
    w = _points(1024, 43, dev)
    for f in (2, 4, 8):
        assert _same(kernels.reduce_block(w, f), kernels.reduce_block_plain(w, f))
    t = _points(2 * 128, 44, dev, (16, 1, 256))
    assert _same(kernels.tail_horner(t, 2), kernels.tail_horner_plain(t, 2))
    b = _points(1024, 47, dev)
    tabs = kernels.table_flat(b)
    for got, want in zip(tabs, kernels.table_flat_plain(b)):
        got, want = (limb.normalize(t.view(-1, 16, 1024).transpose(0, 1)) for t in (got, want))
        assert torch.equal(got, want)
    rng = np.random.default_rng(48)
    absd = torch.as_tensor(rng.integers(0, 9, size=(1, 2, 1024)), device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(1, 2, 1024)), device=dev)
    assert _same(kernels.select_reduce(tabs, absd, sgn), kernels.select_reduce_plain(tabs, absd, sgn))
    e, o = kernels.table_flat(_points(64, 45, dev)), kernels.table_flat(_points(64, 46, dev))
    digits = np.stack([*glv.recode_signed(-(3**80)), *glv.recode_signed(5**50)])
    assert _same(kernels.fold(e, o, digits), kernels.fold_plain(e, o, digits))
    assert all(n > 0 for n in kernels.counts().values())
