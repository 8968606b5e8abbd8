"""The host side of the redesigned fold and select_reduce kernels, on the
CPU: the fold wrapper's digit packing (the kernel takes the digits by
value) and its checks, select_reduce's plain version at two MSMs with a
row of zero digits and sign 1 against exact host integers, and the two
kernels' bounds.  The kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch import bounds
from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core.fields import Q
from bulletproofspp_tpu_torch.ops import curve, glv, kernels, limb


def _digits():
    return np.stack([*glv.recode_signed(-(3**80)), *glv.recode_signed(5**50)])


def test_fold_digits_pack_the_four_streams_row_by_row():
    d = _digits()
    packed = kernels.fold_digits(d)
    assert len(packed) == 4 * glv.ROWS == 132
    assert [packed[33 * q + r] for q in range(4) for r in range(33)] == [int(v) for v in d.flat]
    edge = d.copy()
    edge[0, :3], edge[1, :3] = 0, 1  # zero digits with sign 1 are valid
    edge[2, :], edge[3, :] = 8, 1
    assert kernels.fold_digits(edge.tolist()) == edge.astype(np.uint8).tobytes()


@pytest.mark.parametrize("case", ["rows 32", "rows 34", "three streams", "magnitude 9",
                                  "negative", "sign 2", "floats"])
def test_fold_digits_reject_what_the_kernel_cannot_take(case):
    d = _digits().astype(np.int64)
    bad = {
        "rows 32": d[:, :32], "rows 34": np.concatenate([d, d[:, :1]], 1), "three streams": d[:3],
        "magnitude 9": np.where(np.arange(33) == 7, 9, d),
        "negative": d - (np.arange(4) == 2)[:, None] * 9,
        "sign 2": np.where((np.arange(4) == 3)[:, None] & (np.arange(33) == 0), 2, d),
        "floats": d.astype(np.float64),
    }[case]
    with pytest.raises(ValueError, match="fold digits"):
        kernels.fold_digits(bad)


def _tables(n: int, seed: int):
    """Flat tables of n lanes (multiples of 16 host points, each lane its
    own projective scaling, every 7th lane the identity) and the lanes'
    affine points (None for the identity)."""
    rng = np.random.default_rng(seed)
    base = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=16)]
    cols, pts = ([], [], []), []
    for i in range(n):
        pt = None if i % 7 == 3 else base[int(rng.integers(0, 16))]
        z = int(rng.integers(1, 2**62)) << 150
        coords = (0, z % Q, 0) if pt is None else (pt[0] * z % Q, pt[1] * z % Q, z % Q)
        for c, v in zip(cols, coords):
            c.append(v)
        pts.append(pt)
    return kernels.table_flat_plain(tuple(limb.from_ints(c, "cpu") for c in cols)), pts


def test_fold_wrapper_checks_digits_and_takes_the_plain_version_on_cpu():
    te, _ = _tables(16, 80)
    to, _ = _tables(16, 81)
    d = _digits()
    kernels.reset_counts()
    got = kernels.fold(te, to, d)
    assert kernels.counts()["fold"] == 0 and kernels.shape_counts()["fold"] == {}
    assert torch.equal(curve.normalize3(*got), curve.normalize3(*kernels.fold_plain(te, to, d)))
    with pytest.raises(ValueError, match="fold digits"):
        kernels.fold(te, to, d[:, 1:])


def test_select_reduce_plain_two_msms_with_a_zero_sign_row_equal_host_integers():
    batch, rows, L = 2, 3, 1024
    tables, pts = _tables(batch * L, 82)
    rng = np.random.default_rng(83)
    absd = rng.integers(0, 9, size=(batch, rows, L)).astype(np.uint8)
    sgn = rng.integers(0, 2, size=(batch, rows, L)).astype(np.uint8)
    absd[:, 1], sgn[:, 1] = 0, 1  # every entry (0 : -1 : 0)
    absd_t, sgn_t = torch.as_tensor(absd), torch.as_tensor(sgn)
    kernels.reset_counts()
    got = kernels.select_reduce(tables, absd_t, sgn_t)  # CPU tensors: the plain version
    for staged in (True, False):
        other = kernels.select_reduce_design(tables, absd_t, sgn_t, staged)
        assert torch.equal(curve.normalize3(*got), curve.normalize3(*other))
    assert sum(kernels.counts().values()) == 0
    want = []
    for b in range(batch):
        for r in range(rows):
            for q in range(L // 8):
                acc = None
                for m in range(8):
                    lane = (q // 128) * 1024 + q % 128 + m * 128
                    p = pts[b * L + lane]
                    p = ec.scalar_mul(int(absd[b, r, lane]), p) if p else None
                    acc = ec.add(acc, ec.neg(p) if p and sgn[b, r, lane] else p)
                want.append(acc)
    assert curve.to_affine_host(got) == want
    zero_row = [curve.to_affine_host(tuple(c[:, (b * rows + 1) * 128:(b * rows + 2) * 128]
                                           for c in got)) for b in range(batch)]
    assert zero_row == [[None] * 128] * batch


def test_select_reduce_and_fold_bounds_count_what_the_kernels_read():
    # lane 0: |d| {0, 3} -> entry 3; lane 1: |d| {1, 2} -> entries 1 and 2
    absd = torch.tensor([[[0, 1], [0, 2], [3, 2]]], dtype=torch.uint8)
    sgn = torch.tensor([[[0, 0], [1, 0], [0, 1]]], dtype=torch.uint8)
    ops, nbytes = bounds.select_reduce(absd, sgn, factor=2)
    assert nbytes == 3 * 3 * bounds.FE_BYTES + 6 * 2 + 3 * bounds.PT_BYTES  # a byte a digit
    assert ops == 3 * bounds.PT_ADD + 2 * bounds.FE_SUB  # two negative digits negate Y
    d = [[1, 1, 0], [0, 1, 1], [2, 2, 2], [0, 0, 0]]  # E: |d| {0, 1}, y {1, 9, 10}; O: {2}, {2}
    ops, nbytes = bounds.fold(8, d)
    assert nbytes == 8 * ((2 * 2 + 3 + 2 * 1 + 1) * bounds.FE_BYTES + bounds.PT_BYTES)
    assert ops == 8 * 3 * (4 * bounds.PT_DBL + 2 * bounds.PT_ADD)
