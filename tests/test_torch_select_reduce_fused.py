"""select_reduce_fused on the CPU: its plain version against
select_reduce_fused_pallas in interpret mode (1,024 lanes, 2 rows), its
batch layout, and the MSM route that takes it from SCRATCH_TABLE_MIN_L
lanes.  Exact comparison of normalized projective outputs; the CUDA kernel
against the plain version: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from bulletproofspp_tpu.core import ec  # noqa: E402
from bulletproofspp_tpu.core.engine import HostEngine  # noqa: E402
from bulletproofspp_tpu.ops import pallas_field  # noqa: E402
from bulletproofspp_tpu_torch.ops import kernels, msm  # noqa: E402
from bulletproofspp_tpu_torch.ops.engine import TorchEngine  # noqa: E402

from test_torch_kernels import _canon_jax, _canon_port, _jax, _points, _port  # noqa: E402

L = 1024


def _digits(rng, shape):
    absd = rng.integers(0, 9, size=shape).astype(np.uint32)
    sgn = rng.integers(0, 2, size=shape).astype(np.uint32)
    return absd, sgn


def _t(a):
    return torch.as_tensor(a.astype(np.uint8))


def test_select_reduce_fused_plain_matches_select_reduce_fused_pallas():
    rows = 2
    p, _ = _points(L, 60)
    absd, sgn = _digits(np.random.default_rng(61), (rows, L))
    got = kernels.select_reduce_fused_plain(_port(p), _t(absd[None]), _t(sgn[None]))
    want = pallas_field.select_reduce_fused_pallas(*_jax(p), *_jax((absd, sgn)), interpret=True)
    assert got[0].shape == (16, rows * L // 8)
    assert np.array_equal(_canon_port(got), _canon_jax(want))


def test_select_reduce_fused_batch_layout():
    """B stacked MSMs: entry b's partials are the single MSM's, in order."""
    rows, batch = 3, 2
    p, _ = _points(batch * L, 62)
    absd, sgn = _digits(np.random.default_rng(63), (batch, rows, L))
    got = _canon_port(kernels.select_reduce_fused(_port(p), _t(absd), _t(sgn)))
    one = [
        _canon_port(kernels.select_reduce_fused(
            tuple(c[:, b * L : (b + 1) * L].contiguous() for c in _port(p)),
            _t(absd[b : b + 1]), _t(sgn[b : b + 1])))
        for b in range(batch)
    ]
    assert np.array_equal(got, np.concatenate(one, -1))
    with pytest.raises(ValueError):
        kernels.select_reduce_fused(_port(p), _t(absd[:1]), _t(sgn[:1]))  # 2,048 lanes for 1,024


def test_msm_routes_scratch_sizes_to_select_reduce_fused(monkeypatch):
    monkeypatch.setattr(msm, "SCRATCH_TABLE_MIN_L", 1024)
    shapes = []
    fused = kernels.select_reduce_fused

    def spy(p, absd, sgn):
        shapes.append(tuple(absd.shape))
        return fused(p, absd, sgn)

    def refuse(*a):
        raise AssertionError("select_reduce ran at a scratch-table size")

    monkeypatch.setattr(kernels, "select_reduce_fused", spy)
    monkeypatch.setattr(kernels, "select_reduce", refuse)
    monkeypatch.setattr(kernels, "table_flat", refuse)
    rng = np.random.default_rng(64)
    base = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=8)]
    pairs = [(int.from_bytes(rng.bytes(32), "little"), base[i % 8]) for i in range(300)]
    pairs += [(7, None), (0, base[0])]
    got = TorchEngine("cpu").msm(pairs)  # 300 points: 600 GLV lanes, bucket 1,024
    assert shapes == [(1, 33, 1024)]
    assert got is not None and got == HostEngine().msm(pairs)
