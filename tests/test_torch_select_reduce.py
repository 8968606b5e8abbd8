"""The table_flat and select_reduce kernels' plain PyTorch versions against
table_flat_pallas and select_reduce_pallas in interpret mode, at the
smallest width they take (1,024 lanes) and a few digit rows.  Exact
comparison of normalized projective outputs."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from bulletproofspp_tpu.ops import pallas_field  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, kernels, limb  # noqa: E402

from test_torch_kernels import _canon_jax, _canon_port, _jax, _points, _port  # noqa: E402

L = 1024


def _canon_table(t, entries):
    """(16 E, N) flat planes -> normalized (E, 16, N) numpy."""
    n = t.shape[1]
    return limb.planes_to_numpy(limb.normalize(t.view(entries, limb.NLIMB, n).permute(1, 0, 2)))


def _canon_jax_table(t, entries):
    from bulletproofspp_tpu.ops import limb as jlimb

    n = t.shape[1]
    arr = np.asarray(t).reshape(entries, 16, n).transpose(1, 0, 2).reshape(16, -1)
    return np.asarray(jlimb.normalize(arr)).reshape(16, entries, n)


@pytest.fixture(scope="module")
def tables():
    p, _ = _points(L, 50)
    return p, kernels.table_flat_plain(_port(p)), pallas_field.table_flat_pallas(*_jax(p), interpret=True)


def test_table_flat_plain_matches_table_flat_pallas(tables):
    _, got, want = tables
    for g, w, e in zip(got, want, (9, 18, 9)):
        assert g.shape == w.shape
        assert np.array_equal(_canon_table(g, e), _canon_jax_table(w, e))


def test_select_reduce_plain_matches_select_reduce_pallas(tables):
    _, got_t, want_t = tables
    rows = 2
    rng = np.random.default_rng(51)
    absd = rng.integers(0, 9, size=(rows, L)).astype(np.uint32)
    sgn = rng.integers(0, 2, size=(rows, L)).astype(np.uint32)
    got = kernels.select_reduce_plain(
        got_t, torch.as_tensor(absd[None], dtype=torch.int64), torch.as_tensor(sgn[None], dtype=torch.int64)
    )
    want = pallas_field.select_reduce_pallas(*want_t, *_jax((absd, sgn)), interpret=True)
    assert got[0].shape == (16, rows * L // 8)
    assert np.array_equal(_canon_port(got), _canon_jax(want))


def test_table_flat_entries_are_the_multiples(tables):
    """Entry e is e P and entry e + 9 of the Y table is -Y (first 64 lanes)."""
    from bulletproofspp_tpu.core import ec

    _, got, _ = tables
    p, pts = _points(64, 50)
    n = got[0].shape[1]
    tx, ty2, tz = (t.view(-1, limb.NLIMB, n)[..., :64] for t in got)
    for e in range(9):
        want = [ec.scalar_mul(e, q) if q else None for q in pts]
        assert curve.to_affine_host((tx[e], ty2[e], tz[e])) == want
        assert curve.to_affine_host((tx[e], ty2[e + 9], tz[e])) == [q and ec.neg(q) for q in want]
