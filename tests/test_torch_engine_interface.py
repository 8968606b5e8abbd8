"""``TorchEngine.fold_bases`` and ``shared_mul``, the rest of
``core/engine.py``'s interface, on the CPU: exactly the JAX package's
``HostEngine`` at 1, 16, 17 and 130 lanes (None lanes, zero scalars and
negative fold scalars among the cases), and its ``JaxEngine`` with the
device path forced (``host_below=0``) at 16 lanes."""

import random

import pytest

from bulletproofspp_tpu.core.engine import HostEngine as JHostEngine
from bulletproofspp_tpu.ops.engine import JaxEngine
from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core.fields import R
from bulletproofspp_tpu_torch.ops import kernels
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

from torch_threads import one_thread  # noqa: F401

ENGINE = TorchEngine("cpu")


def _lanes(n: int, seed: int):
    """n affine points, every 5th lane (from lane 2) None."""
    rng = random.Random(seed)
    return [None if i % 5 == 2 else ec.scalar_mul(rng.randrange(1, R), ec.G) for i in range(n)]


def _fold_scalars(seed: int):
    """(b, a) pairs of the argument's size (the GLV halves' 128 bits and
    signs), and zeros."""
    rng = random.Random(seed)
    return [(rng.randrange(2**127), -rng.randrange(2**127)), (0, rng.randrange(2**127)), (0, 0)]


def _shared_scalars(seed: int):
    rng = random.Random(seed)
    return [rng.randrange(R), 0, R - 1]


@pytest.mark.parametrize("n", [1, 16, 17, 130])
def test_fold_bases_equals_the_jax_host_engine(n):
    even, odd = _lanes(n, n), _lanes(n, 1000 + n)
    for b, a in _fold_scalars(n):
        got = ENGINE.fold_bases(b, a, even, odd)
        assert isinstance(got, list) and len(got) == n
        assert got == JHostEngine().fold_bases(b, a, even, odd), (b, a)
    assert ENGINE.fold_bases(3, 5, [], []) == []


@pytest.mark.parametrize("n", [1, 16, 17, 130])
def test_shared_mul_equals_the_jax_host_engine(n):
    pts = _lanes(n, 2000 + n)
    for k in _shared_scalars(n):
        got = ENGINE.shared_mul(k, pts)
        assert isinstance(got, list) and len(got) == n
        assert got == JHostEngine().shared_mul(k, pts), k
    assert ENGINE.shared_mul(7, []) == []


def test_fold_bases_and_shared_mul_equal_the_jax_engine_device_path():
    """One XLA compile of the JAX package's fold at 16 lanes serves both."""
    jeng = JaxEngine(host_below=0)
    even, odd = _lanes(16, 3), _lanes(16, 4)
    for b, a in _fold_scalars(5):
        assert ENGINE.fold_bases(b, a, even, odd) == jeng.fold_bases(b, a, even, odd)
    for k in _shared_scalars(6):
        assert ENGINE.shared_mul(k, even) == jeng.shared_mul(k, even)


def test_each_runs_one_fold_on_the_fold_path(monkeypatch):
    """fold_bases is fold_bv and a copy to the host; shared_mul one fold of
    (P, phi(P)) with the GLV halves of k, phi made in the fold's launch: one
    fold_many call each (shared_mul's through fold_phi) and no table_flat,
    fold or endo call, whatever the width (no host shortcut)."""
    calls = []
    for name in ("fold", "table_flat", "fold_many", "fold_phi", "endo"):
        inner = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda *a, _n=name, _f=inner: calls.append(_n) or _f(*a))
    pts = _lanes(3, 7)
    ENGINE.fold_bases(1, 2, pts, pts)
    assert calls == ["fold_many"]
    calls.clear()
    ENGINE.shared_mul(9, pts)
    assert calls == ["fold_phi"]
