"""horner's plain version on the CPU against exact host integers, on edge
rows (tests/test_torch_kernels.py holds it against horner_pallas in
interpret mode; the warp kernel against it on the card:
tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import torch

from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core.fields import Q
from bulletproofspp_tpu_torch.ops import curve, kernels, limb


def test_horner_plain_on_edge_rows_equals_host_integers():
    """3 MSMs of 3 rows, each point with its own projective Z: row 0 all
    identity; row 1 a multiple P of G; row 2 -16 P in MSM 0 (the addition
    after the doublings is 16 P + (-16 P)), 16 P in MSM 1 (16 P + 16 P)
    and another multiple Q of G in MSM 2.  The answer, sum_r 16^(2 - r) row
    r, from host integers."""
    batch, rows = 3, 3
    rng = np.random.default_rng(90)
    p = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=batch)]
    q = ec.scalar_mul(int(rng.integers(1, 2**62)), ec.G)
    grid = [[None, p[b], [ec.neg(ec.scalar_mul(16, p[0])), ec.scalar_mul(16, p[1]), q][b]]
            for b in range(batch)]
    cols = ([], [], [])
    for b in range(batch):
        for pt in grid[b]:
            z = int(rng.integers(1, 2**62)) << 120
            coords = (0, z % Q, 0) if pt is None else (pt[0] * z % Q, pt[1] * z % Q, z % Q)
            for c, v in zip(cols, coords):
                c.append(v)
    r = tuple(limb.from_ints(c, "cpu").reshape(16, batch, rows) for c in cols)
    want = [None, ec.scalar_mul(32, p[1]), ec.add(ec.scalar_mul(16, p[2]), q)]
    assert curve.to_affine_host(kernels.horner_plain(*r)) == want
    kernels.reset_counts()
    got = kernels.horner(*r)  # CPU tensors: the plain version
    assert kernels.counts()["horner"] == 0 and kernels.shape_counts()["horner"] == {}
    assert got[0].shape == (16, batch)
    assert torch.equal(curve.normalize3(*got), curve.normalize3(*kernels.horner_plain(*r)))
