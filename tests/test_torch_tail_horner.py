"""The tail_horner kernel's plain PyTorch version against
tail_horner_pallas in interpret mode (its own file: interpreting the
Pallas kernel's seven roll levels and Horner loop takes about a minute on
one CPU worker), and against exact host integers on edge rows.  Exact
comparison of normalized projective outputs."""

import numpy as np
import pytest

pytest.importorskip("jax")

from bulletproofspp_tpu.ops import pallas_field  # noqa: E402
from bulletproofspp_tpu_torch.core import ec  # noqa: E402
from bulletproofspp_tpu_torch.core.fields import Q, R  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, kernels, limb  # noqa: E402

from test_torch_kernels import _canon_jax, _canon_port, _jax, _points, _port  # noqa: E402


def test_tail_horner_plain_matches_tail_horner_pallas():
    rows = 2
    p, _ = _points(rows * 128, 20)
    want = pallas_field.tail_horner_pallas(_jax(p), rows, interpret=True)
    got = kernels.tail_horner_plain(_port(p, (16, 1, rows * 128)), rows)
    assert np.array_equal(_canon_port(got), _canon_jax(want))


def test_tail_horner_plain_equals_host_integers_on_edge_rows():
    """3 MSMs of 3 rows: row 0 all identity, row 1 lanes t + 64 the
    negation of lanes t (both sum to the identity), row 2 random multiples
    of G; each lane scaled by its own Z.  The answer, sum_r 16^(2 - r) (row
    r's sum), from host integers."""
    batch, rows = 3, 3
    rng = np.random.default_rng(21)
    ks = [int(k) for k in rng.integers(1, 2**62, size=16)]
    base = [ec.scalar_mul(k, ec.G) for k in ks]
    cols, want = ([], [], []), []
    for _ in range(batch):
        idx = rng.integers(0, len(ks), size=(rows, 128))
        total = 0
        for r in range(rows):
            for t in range(128):
                i = int(idx[r, t % 64 if r == 1 else t])
                k, pt = ks[i], base[i]
                if r == 1 and t >= 64:
                    k, pt = R - k, ec.neg(pt)
                z = int(rng.integers(1, 2**62)) << 100
                if r == 0:
                    k, coords = 0, (0, z % Q, 0)
                else:
                    coords = (pt[0] * z % Q, pt[1] * z % Q, z % Q)
                for c, v in zip(cols, coords):
                    c.append(v)
                total += k << (4 * (rows - 1 - r))
        want.append(ec.scalar_mul(total % R, ec.G))
    p = tuple(limb.from_ints(c, "cpu").reshape(16, batch, rows * 128) for c in cols)
    kernels.reset_counts()
    got = kernels.tail_horner(p, rows)  # a CPU tensor: the plain version
    assert kernels.counts()["tail_horner"] == 0
    assert curve.to_affine_host(got) == want
