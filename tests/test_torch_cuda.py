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

from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core.fields import Q
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
    absd = torch.as_tensor(rng.integers(0, 9, size=(1, 2, 1024)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(1, 2, 1024)), dtype=torch.uint8, device=dev)
    assert _same(kernels.select_reduce(tabs, absd, sgn), kernels.select_reduce_plain(tabs, absd, sgn))
    e, o = kernels.table_flat(_points(64, 45, dev)), kernels.table_flat(_points(64, 46, dev))
    digits = np.stack([*glv.recode_signed(-(3**80)), *glv.recode_signed(5**50)])
    assert _same(kernels.fold(e, o, digits), kernels.fold_plain(e, o, digits))
    # two provers of 32 lanes, with their own digits, from the bases' points
    many = np.stack([digits, np.stack([*glv.recode_signed(7**40), *glv.recode_signed(-(2**100))])])
    pe, po = _points(64, 45, dev), _points(64, 46, dev)
    assert _same(kernels.fold_many(pe, po, many), kernels.fold_many_plain(pe, po, many))
    # the square completion of the same two provers, 16 lanes each
    g0, g1 = _points(32, 45, dev), _points(32, 46, dev)
    for got, want in zip(kernels.complete_square(g0, g1, many),
                         kernels.complete_square_plain(g0, g1, many)):
        assert _same(got, want)
    # two stacked MSMs of 1,024 lanes, 3 rows
    pts = _points(2 * 1024, 49, dev)
    absd = torch.as_tensor(rng.integers(0, 9, size=(2, 3, 1024)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(2, 3, 1024)), dtype=torch.uint8, device=dev)
    assert _same(kernels.select_reduce_fused(pts, absd, sgn),
                 kernels.select_reduce_fused_plain(pts, absd, sgn))
    # random x's (about half non-residues) and the edge values 0, 1, p - 1
    xs = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(253)] + [0, 1, Q - 1]
    x = limb.from_ints(xs, dev)
    sign = torch.as_tensor(rng.integers(0, 2, size=256), device=dev)
    (y, ok), (py, pok) = kernels.decompress(x, sign), kernels.decompress_plain(x, sign)
    assert torch.equal(y, py) and torch.equal(ok, pok) and 0 < int(ok.sum()) < 256
    # the affine conversion, canonical out: z = 0, Q and p - 1 among random lanes
    z = limb.from_ints(xs[:253] + [0, Q, Q - 1], dev)
    assert torch.equal(kernels.inv(z), kernels.inv_plain(z))
    for got, want in zip(kernels.to_affine(x, x, z), kernels.to_affine_plain(x, x, z)):
        assert torch.equal(got, want)
    # the lane-wise functions (csrc/lanes.cu): two MSMs of 64 lanes' select,
    # endo with and without the interleave, pneg, normalize3
    tabs = kernels.table_flat(_points(2 * 64, 50, dev))
    absd = torch.as_tensor(rng.integers(0, 9, size=(2, 33, 64)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(2, 33, 64)), dtype=torch.uint8, device=dev)
    assert all(torch.equal(a, b) for a, b in zip(kernels.select_small(tabs, absd, sgn),
                                                 kernels.select_plain(tabs, absd, sgn)))
    p = _points(64, 51, dev, (16, 2, 32))
    assert _same(kernels.endo(p, interleave=True), kernels.endo_plain(p, interleave=True))
    assert _same(kernels.endo(p), kernels.endo_plain(p))
    assert _same(kernels.pneg(p), kernels.pneg_plain(p))
    assert torch.equal(kernels.normalize3(*p), kernels.normalize3_plain(*p))
    # the engine's assembly (a slice padded to 64 lanes, word for word) and
    # the small MSMs' select and lane tree (two MSMs of 64 lanes), also the
    # tree alone over 16 lanes
    segs = [[[tuple(c[:, 3:40] for c in _points(64, 52, dev))]]]
    for got, want in zip(kernels.assemble(segs, 64), kernels.assemble_plain(segs, 64)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _same(kernels.reduce_lanes(tabs, absd, sgn), kernels.reduce_lanes_plain(tabs, absd, sgn))
    sel = _points(2 * 33 * 16, 53, dev, (16, 2, 33, 16))
    assert _same(kernels.reduce_lanes_tree(sel), kernels.reduce_lanes_tree_plain(sel))
    launched = kernels.counts()
    assert all(launched[k] > 0 for k in launched if k not in ("sr_variant", "grid_copy", "chain"))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("blk,out_w,noselect", [(1024, 128, False), (1024, 128, True),
                                                (2048, 128, False), (512, 256, False),
                                                (64, 16, False), (8, 4, True)])
def test_cuda_sr_variant_matches_plain_version(blk, out_w, noselect):
    dev = _card()
    tabs = kernels.table_flat(_points(2048, 60, dev))
    rng = np.random.default_rng(61)
    absd = torch.as_tensor(rng.integers(0, 9, size=(3, 2048)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(3, 2048)), dtype=torch.uint8, device=dev)
    kernels.reset_counts()
    got = kernels.sr_variant(tabs, absd, sgn, blk, out_w, noselect)
    assert kernels.counts()["sr_variant"] == 1
    assert _same(got, kernels.sr_variant_plain(tabs, absd, sgn, blk, out_w, noselect))
    if (blk, out_w, noselect) == (1024, 128, False):
        want = kernels.select_reduce(tabs, absd[None], sgn[None])
        assert all(torch.equal(a, b) for a, b in zip(got, want))  # limb for limb


def _tail_lanes(batch: int, rows: int, seed: int, dev):
    """(16, batch, rows * 128) lanes for tail_horner: 256 of ``_points``'
    lanes repeated, each scaled by its own random factor; in every MSM row
    0 is all identity and in row 1 lane t + 64 is the negation of lane t
    (scaled again), so both rows sum to the identity."""
    n = batch * rows * 128
    rng = np.random.default_rng(seed)

    def factor(*shape):
        return torch.as_tensor(rng.integers(1, 1 << 16, size=(16, *shape)), device=dev)

    k = factor(n)
    x, y, z = (limb.mul(c.repeat(1, -(-n // 256))[:, :n], k).reshape(16, batch, rows, 128)
               for c in _points(256, seed, dev))
    x[:, :, 0], z[:, :, 0] = 0, 0
    k = factor(batch, 64)
    x[:, :, 1, 64:] = limb.mul(x[:, :, 1, :64], k)
    y[:, :, 1, 64:] = limb.neg(limb.mul(y[:, :, 1, :64], k))
    z[:, :, 1, 64:] = limb.mul(z[:, :, 1, :64], k)
    return tuple(c.reshape(16, batch, rows * 128) for c in (x, y, z))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 130])  # 130: msm_many's K
def test_cuda_tail_horner_matches_plain_version(batch):
    dev = _card()
    p = _tail_lanes(batch, 33, 66, dev)
    kernels.reset_counts()
    got = kernels.tail_horner(p, 33)
    assert kernels.counts()["tail_horner"] == 1
    assert got[0].shape == (16, batch)
    assert _same(got, kernels.tail_horner_plain(p, 33))


@pytest.mark.cuda
@pytest.mark.parametrize("blk", [1024, 2048])
def test_cuda_grid_copy_matches_plain_version(blk):
    dev = _card()
    x = torch.as_tensor(np.random.default_rng(62).integers(0, 1 << 16, size=(16, 4096)), device=dev)
    x[:, :3] = 0xFFFFFFFF  # wraps to 0
    x[:, blk - 1] = 0xFFFFFFFF  # the last lane of a block
    kernels.reset_counts()
    assert torch.equal(kernels.grid_copy(x, blk), kernels.grid_copy_plain(x))
    assert kernels.counts()["grid_copy"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("phase", sorted(kernels.CHAIN_PHASES))
def test_cuda_chain_matches_plain_version(phase):
    dev = _card()
    rng = np.random.default_rng(63)
    _, nstate, value = kernels.CHAIN_PHASES[phase]
    a, b = ([torch.as_tensor(rng.integers(0, 1 << 16, size=(16, 512)), device=dev)
             for _ in range(k)] for k in (nstate, 3))
    for t in (*a, *b):
        t[:, :4] = 0xFFFF  # saturated lanes
    a[0][:, 4:7] = limb.from_ints([0, Q - 1, (1 << 256) - 1], dev)
    model = {"mul_f16": "mul", "add": "add", "sub": "sub"}.get(phase)
    for rep in (1, 8):
        got, want = kernels.chain(phase, a, b, rep), kernels.chain_plain(phase, a, b, rep)
        if model:  # field.cuh's representative, word for word
            words = a[0]
            for _ in range(rep):
                words = kernels.field_words(model, words, b[0])
            assert torch.equal(got, words), rep
        if value:
            got, want = limb.normalize(got), limb.normalize(want)
        assert torch.equal(got, want), rep


@pytest.mark.cuda
@pytest.mark.parametrize("phase", sorted(kernels.ROUND_PHASES))
def test_cuda_round_phases_match_plain_version(phase):
    """The point chains' rounds (a product on one thread, and on two) on a
    group of G threads a lane at 520 lanes (not a multiple of a block's lanes),
    saturated and edge limbs among them, equal to their plain versions
    after normalization; the clocks hold each part's cycles."""
    dev = _card()
    rng = np.random.default_rng(67)
    a, b = ([torch.as_tensor(rng.integers(0, 1 << 16, size=(16, 520)), device=dev)
             for _ in range(3)] for _ in range(2))
    for t in (*a, *b):
        t[:, :4] = 0xFFFF
    a[0][:, 4:7] = limb.from_ints([0, Q - 1, (1 << 256) - 1], dev)
    for rep in (1, 8):
        got = kernels.round_chain(phase, a, b, rep)
        assert torch.equal(limb.normalize(got),
                           limb.normalize(kernels.round_chain_plain(phase, a, b, rep))), rep
    clocks = torch.zeros((len(kernels.ROUND_PARTS), 520), dtype=torch.int64, device=dev)
    assert torch.equal(kernels.round_chain(phase, a, b, 8, clocks), got)
    assert bool((clocks.sum(0) > 0).all())


@pytest.mark.cuda
def test_cuda_padd_thread_counts_agree():
    dev = _card()
    p, q = _points(4096, 64, dev), _points(4096, 65, dev)
    want = kernels.padd_plain(p, q)
    for threads in kernels.PADD_THREADS:
        assert _same(kernels.padd(p, q, threads), want), threads


def _edge_digits():
    """Fold digits (4, 33) with rows of zero digits and sign 1 in both
    streams (they select (0 : -1 : 0))."""
    d = np.stack([*glv.recode_signed(-(7**45)), *glv.recode_signed(11**36)])
    d[0, :4], d[1, :4] = 0, 1
    d[2, 10:13], d[3, 10:13] = 0, 1
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 512, 520])  # 520: not a multiple of a block's 4 warps
def test_cuda_fold_matches_plain_version(L):
    dev = _card()
    e, o = kernels.table_flat(_points(L, 70, dev)), kernels.table_flat(_points(L, 71, dev))
    digits = _edge_digits()
    kernels.fold(e, o, digits)  # builds the library
    torch.cuda.synchronize()
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode("error")  # an upload of the digits would synchronize
    try:
        got = kernels.fold(e, o, digits)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.counts()["fold"] == 1
    assert _same(got, kernels.fold_plain(e, o, digits))


def _prover_digits(B: int, seed: int):
    """(B, 4, 33) fold digits, each prover's own; prover 0's streams have
    rows of zero digits with sign 1 (``_edge_digits``)."""
    rng = np.random.default_rng(seed)
    out = [_edge_digits()]
    for _ in range(B - 1):
        b, a = (int(v) << 64 for v in rng.integers(1, 2**62, size=2))
        out.append(np.stack([*glv.recode_signed(-b), *glv.recode_signed(a)]))
    return np.stack(out)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 16), (2, 16), (16, 16), (2, 520), (20, 16)])
def test_cuda_fold_many_matches_plain_version(B, L):
    """B provers of L lanes each from the bases' points in one launch (20:
    two launches of 16 and 4 provers); at B = 1 word for word table_flat +
    fold's output; every group width gives the same words.  Neither the
    digits nor anything else is uploaded: the launches do not synchronize."""
    dev = _card()
    pe, po = _points(B * L, 72, dev), _points(B * L, 73, dev)
    digits = _prover_digits(B, 74)
    kernels.fold_many(pe, po, digits)  # builds the library
    torch.cuda.synchronize()
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernels.fold_many(pe, po, digits)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    chunks = [min(16, B - p0) for p0 in range(0, B, 16)]
    assert kernels.shape_counts()["fold_many"] == {
        f"B={c} L={L} G={kernels.fold_many_group(c * L)}": 1 for c in chunks}
    assert kernels.counts()["table_flat"] == 0
    assert _same(got, kernels.fold_many_plain(pe, po, digits))
    for g in kernels.FOLD_MANY_GROUPS:
        assert all(torch.equal(a, b) for a, b in
                   zip(got, kernels.fold_many_design(pe, po, digits, g))), g
    if B == 1:
        want = kernels.fold(kernels.table_flat(pe), kernels.table_flat(po), digits[0])
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 520, 4096])  # 4,096: the 8-thread group
def test_cuda_fold_phi_equals_endo_and_the_fold(L):
    """fold_many with phi(E) made in the launch: one fold_many launch, word
    for word endo + table_flat x 2 + fold and fold_many(p, endo(p)), and its
    plain version after normalization."""
    dev = _card()
    p = _points(L, 75, dev)
    digits = _prover_digits(1, 76)
    kernels.fold_phi(p, digits)  # builds the library
    torch.cuda.synchronize()
    kernels.reset_counts()
    got = kernels.fold_phi(p, digits)
    g = kernels.fold_many_group(L)
    assert kernels.shape_counts()["fold_many"] == {f"B=1 L={L} G={g} phi": 1}
    assert sum(kernels.counts().values()) == 1
    phi = kernels.endo(p)
    for want in (kernels.fold(kernels.table_flat(p), kernels.table_flat(phi), digits[0]),
                 kernels.fold_many(p, phi, digits)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _same(got, kernels.fold_phi_plain(p, digits))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 16), (2, 16), (16, 16), (16, 128), (20, 16)])
def test_cuda_complete_square_equals_the_unfused_route(B, L):
    """g1 +- r g0 of B provers of L lanes in one launch a 16 provers (16 x
    128: 2,048 lanes, the 8-thread group): word for word the route it
    replaced, endo, fold_many, padd(g1, rp) and padd(g1, pneg(rp)), and its
    plain version after normalization; nothing uploaded or synchronized."""
    dev = _card()
    g0, g1 = _points(B * L, 75, dev), _points(B * L, 76, dev)
    digits = _prover_digits(B, 77)
    kernels.complete_square(g0, g1, digits)  # builds the library
    torch.cuda.synchronize()
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gx, hy = kernels.complete_square(g0, g1, digits)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    chunks = [min(16, B - p0) for p0 in range(0, B, 16)]
    assert kernels.shape_counts()["complete_square"] == {
        f"B={c} L={L} G={kernels.fold_many_group(c * L)}": 1 for c in chunks}
    assert {k for k, n in kernels.counts().items() if n} == {"complete_square"}
    rp = kernels.fold_many(g0, kernels.endo(g0), digits)
    want = kernels.padd(g1, rp), kernels.padd(g1, kernels.pneg(rp))
    assert all(torch.equal(a, b) for a, b in zip((*gx, *hy), (*want[0], *want[1])))
    plain = kernels.complete_square_plain(g0, g1, digits)
    assert _same(gx, plain[0]) and _same(hy, plain[1])


def _repeat_scaled(p, n: int, seed: int):
    """n lanes: the lanes of p repeated, each scaled by its own random
    factor (another projective representative of the same point)."""
    rng = np.random.default_rng(seed)
    k = torch.as_tensor(rng.integers(1, 1 << 16, size=(16, n)), device=p[0].device)
    return tuple(limb.mul(c.repeat(1, -(-n // c.shape[1]))[:, :n], k) for c in p)


def _wide_tables(n: int, seed: int, dev):
    """Flat tables of n lanes: 1,024 of ``_points``' lanes repeated, each
    scaled by its own random factor."""
    return kernels.table_flat(_repeat_scaled(_points(1024, seed, dev), n, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,L", [(1, 1024), (1, 4096), (3, 4096), (1, 65536)])
def test_cuda_select_reduce_matches_plain_version(batch, L):
    dev = _card()
    tabs = _wide_tables(batch * L, 72, dev)
    rng = np.random.default_rng(73)
    absd = torch.as_tensor(rng.integers(0, 9, size=(batch, 33, L)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(batch, 33, L)), dtype=torch.uint8, device=dev)
    absd[:, 5], sgn[:, 5] = 0, 1  # a row of (0 : -1 : 0)
    kernels.reset_counts()
    got = kernels.select_reduce(tabs, absd, sgn)
    assert kernels.counts()["select_reduce"] == 1
    design = "staged" if batch * L >= kernels.STAGE_MIN_LANES else "rows"
    assert kernels.shape_counts()["select_reduce"] == {f"B={batch} L={L} {design}": 1}
    assert _same(got, kernels.select_reduce_plain(tabs, absd, sgn))
    for staged in (True, False):  # both designs, limb for limb
        other = kernels.select_reduce_design(tabs, absd, sgn, staged)
        assert all(torch.equal(a, b) for a, b in zip(got, other))
    if batch == 1:
        old = kernels.sr_variant(tabs, absd[0], sgn[0], 1024, 128)
        assert all(torch.equal(a, b) for a, b in zip(got, old))


def _horner_rows(batch: int, seed: int, dev):
    """(16, batch, 33) row sums, each point with its own projective Z: row 0
    all identity, row 1 a multiple P of G, row 2 -16 P in even MSMs (16 P +
    (-16 P) after the doublings) and 16 P in odd ones (16 P + 16 P), the
    other rows multiples of G."""
    rng = np.random.default_rng(seed)
    pool = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=32)]
    cols = ([], [], [])
    for b in range(batch):
        p = pool[int(rng.integers(0, len(pool)))]
        sixteen = ec.scalar_mul(16, p)
        row2 = ec.neg(sixteen) if b % 2 == 0 else sixteen
        for r in range(33):
            z = (int(rng.integers(1, 2**62)) << 180) % Q
            if r == 0:
                coords = (0, z, 0)
            else:
                pt = p if r == 1 else row2 if r == 2 else pool[int(rng.integers(0, len(pool)))]
                coords = (pt[0] * z % Q, pt[1] * z % Q, z)
            for c, v in zip(cols, coords):
                c.append(v)
    return tuple(limb.from_ints(c, dev).reshape(16, batch, 33) for c in cols)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 130])  # 130: msm_many's K
def test_cuda_horner_matches_plain_version_word_for_word(batch):
    dev = _card()
    r = _horner_rows(batch, 80, dev)
    kernels.horner(*r)  # builds the library
    torch.cuda.synchronize()
    kernels.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = kernels.horner(*r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.shape_counts()["horner"] == {f"K={batch}": 1}
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.horner_plain(*r)))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,L", [(1, 1024), (1, 4096), (2, 2048)])
def test_cuda_select_reduce_fused_equals_the_two_kernel_route(batch, L):
    dev = _card()
    p = _points(batch * L, 74, dev)  # every 7th lane the identity
    rng = np.random.default_rng(75)
    absd = torch.as_tensor(rng.integers(0, 9, size=(batch, 33, L)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(batch, 33, L)), dtype=torch.uint8, device=dev)
    absd[:, 5], sgn[:, 5] = 0, 1  # a row of (0 : -1 : 0)
    kernels.reset_counts()
    got = kernels.select_reduce_fused(p, absd, sgn)
    assert kernels.shape_counts()["select_reduce_fused"] == {f"B={batch} L={L}": 1}
    two = kernels.select_reduce(kernels.table_flat(p), absd, sgn)
    assert all(torch.equal(a, b) for a, b in zip(got, two))  # limb for limb, raw
    assert _same(got, kernels.select_reduce_fused_plain(p, absd, sgn))


def _padd_pairs(n: int, seed: int, dev):
    """(P, Q) of n lanes, every 7th lane of P the identity; Q by thirds
    another point, P itself (P + P) and -P (P + (-P)), each rescaled."""
    p = _repeat_scaled(_points(min(n, 1024), seed, dev), n, seed)
    other = _repeat_scaled(_points(min(n, 1024), seed + 1, dev), n, seed + 1)
    same = _repeat_scaled(p, n, seed + 2)
    neg = _repeat_scaled((p[0], limb.neg(p[1]), p[2]), n, seed + 3)
    mode = torch.arange(n, device=dev) % 3
    q = tuple(torch.where(mode == 0, a, torch.where(mode == 1, b, c))
              for a, b, c in zip(other, same, neg))
    return p, q


def _designs_under_sync_check(run, picked):
    """Both designs' outputs (``run(narrow)``) and the wrapper's, launched
    while a synchronization would raise."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {narrow: run(narrow) for narrow in (False, True)}
        want = picked()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for narrow, out in outs.items():
        assert all(torch.equal(a, b) for a, b in zip(out, want)), narrow  # word for word
    return want


def _design_counts(L: int, picked: str):
    return {f"L={L} {d}": 1 + (d == picked) for d in ("narrow", "wide")}


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 1056, 65536])  # fold's; the halving trees'; the bench's
def test_cuda_padd_designs_equal_raw_and_the_plain_version(L):
    dev = _card()
    p, q = _padd_pairs(L, 90, dev)
    kernels.padd(p, q)  # builds the library
    kernels.reset_counts()
    got = _designs_under_sync_check(lambda narrow: kernels.padd_design(p, q, narrow),
                                    lambda: kernels.padd(p, q))
    picked = "wide" if L >= kernels.PADD_WIDE_LANES else "narrow"
    assert kernels.shape_counts()["padd"] == _design_counts(L, picked)
    assert _same(got, kernels.padd_plain(p, q))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 512, 4096])  # fold's tables; a small MSM's; 128by64's widest
def test_cuda_table_flat_designs_equal_raw_and_the_plain_version(L):
    """Identity lanes (every 7th), and P + P in every lane (entry 2); a
    point of this group is never the negation of its own multiple 2..7."""
    dev = _card()
    p = _points(L, 91, dev)
    kernels.table_flat(p)  # builds the library
    kernels.reset_counts()
    got = _designs_under_sync_check(lambda narrow: kernels.table_flat_design(p, narrow),
                                    lambda: kernels.table_flat(p))
    picked = "wide" if L >= kernels.TABLE_FLAT_WIDE_LANES else "narrow"
    assert kernels.shape_counts()["table_flat"] == _design_counts(L, picked)
    for a, b in zip(got, kernels.table_flat_plain(p)):
        a, b = (limb.normalize(t.view(-1, 16, L).transpose(0, 1)) for t in (a, b))
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 4, 8])
@pytest.mark.parametrize("n_out", [4224, 0])  # cli test's commonest; 0: the threshold (wide)
def test_cuda_reduce_block_designs_equal_raw_and_the_plain_version(f, n_out):
    """Every factor at a narrow and a wide width: P + P and P + (-P) pairs
    at the first level (every third pair each), identity lanes (every 7th
    of the first half)."""
    dev = _card()
    n_out = n_out or kernels.REDUCE_BLOCK_WIDE_LANES
    w = n_out * f
    p, q = _padd_pairs(w // 2, 92 + f, dev)
    # lane m * 128 + t of a block pairs with lane (m + f/2) * 128 + t first
    blocks = [c.view(16, -1, 64 * f) for c in p], [c.view(16, -1, 64 * f) for c in q]
    pts = tuple(torch.cat([a, b], 2).reshape(16, w).contiguous() for a, b in zip(*blocks))
    kernels.reduce_block(pts, f)  # builds the library
    kernels.reset_counts()
    got = _designs_under_sync_check(lambda narrow: kernels.reduce_block_design(pts, f, narrow),
                                    lambda: kernels.reduce_block(pts, f))
    picked = "wide" if n_out >= kernels.REDUCE_BLOCK_WIDE_LANES else "narrow"
    assert kernels.shape_counts()["reduce_block"] == {
        f"W={w} f={f} {d}": 1 + (d == picked) for d in ("narrow", "wide")}
    assert _same(got, kernels.reduce_block_plain(pts, f))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [16, 64, 16384])  # cli test's; 32by64's; the batch's bucket
def test_cuda_decompress_matches_plain_version_on_every_lane(L):
    """Random x's (about half non-residues), x = 0, 1 and p - 1, both sign
    bits: y and ok equal to the plain version's on every lane."""
    dev = _card()
    rng = np.random.default_rng(L)
    xs = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(L - 3)] + [0, 1, Q - 1]
    x = limb.from_ints(xs, dev)
    sign = torch.as_tensor(np.arange(L) % 2, device=dev)
    (y, ok), (py, pok) = kernels.decompress(x, sign), kernels.decompress_plain(x, sign)
    assert torch.equal(y, py) and torch.equal(ok, pok)
    assert 0 < int(ok.sum()) < L


def _affine_lanes(n: int, seed: int):
    """n affine points, every 5th lane (from lane 2) None."""
    rng = np.random.default_rng(seed)
    return [None if i % 5 == 2 else ec.scalar_mul(int(rng.integers(1, 2**62)) << 190, ec.G)
            for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 520])
def test_cuda_fold_bases_and_shared_mul_equal_host_engine(n):
    """One fold_many launch each on the card (shared_mul's with phi made in
    it) and no fold, equal to HostEngine's affine lists (None lanes, zero
    scalars)."""
    from bulletproofspp_tpu_torch.core.engine import HostEngine
    from bulletproofspp_tpu_torch.core.fields import R
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    eng, host = TorchEngine(_card()), HostEngine()
    even, odd = _affine_lanes(n, 1), _affine_lanes(n, 2)
    for b, a in ((7**45, -(11**36)), (0, 3**80), (0, 0)):
        kernels.reset_counts()
        assert eng.fold_bases(b, a, even, odd) == host.fold_bases(b, a, even, odd)
        assert kernels.counts()["fold_many"] == 1 and kernels.counts()["fold"] == 0
    for k in (R - 12345, 0):
        kernels.reset_counts()
        assert eng.shared_mul(k, even) == host.shared_mul(k, even)
        assert kernels.counts()["fold_many"] == 1 and kernels.counts()["endo"] == 0


@pytest.mark.cuda
def test_cuda_two_party_rec_test_equals_host_engine():
    """rec_test over 2 parties with fixed seeds, dealer and parties on one
    TorchEngine on the card (threads), byte-equal to the same run on
    HostEngine."""
    import json
    import os
    import threading

    from bulletproofspp_tpu_torch import cli
    from bulletproofspp_tpu_torch.core import range_proof as rpm
    from bulletproofspp_tpu_torch.core.engine import HostEngine
    from bulletproofspp_tpu_torch.core.mp_prove import dealer_prove, party_prove
    from bulletproofspp_tpu_torch.core.multiparty import LocalChannel
    from bulletproofspp_tpu_torch.io_ import schema
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    dev = _card()
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                     "rec_test")
    with open(os.path.join(d, "schema.json")) as f:
        spec = schema.parse_spec(json.load(f))
    with open(os.path.join(d, "witness.json")) as f:
        values = cli._resolve_values(spec, schema.parse_witness(json.load(f)))
    setup = schema.build_setup(spec, cli.load_points(spec, schema.points_needed(spec)))
    parts = cli.mp_partition(len(values), 2)

    def run(eng):
        chans = [LocalChannel() for _ in parts]
        threads = [threading.Thread(target=party_prove, daemon=True,
                                    args=(setup, ch, {i: values[i] for i in part},
                                          f"party {k}".encode(), eng))
                   for k, (ch, part) in enumerate(zip(chans, parts))]
        for t in threads:
            t.start()
        proof = dealer_prove(setup, chans, eng)
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        return rpm.encode_proof(setup, proof)

    eng = TorchEngine(dev)
    kernels.reset_counts()
    got = run(eng)
    assert kernels.counts()["fold_many"] > 0
    assert got == run(HostEngine())
    assert rpm.verify(setup, rpm.decode_proof(setup, *got, engine=eng), eng)


def _strict_planes(shape, seed: int, dev):
    """(16, *shape) strict planes of numpy-seeded limbs over the full
    256-bit range (not canonical), the first lanes 0, 1, Q, Q - 1 and
    2^256 - 1."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    t = torch.as_tensor(rng.integers(0, 1 << 16, size=(16, n)), device=dev)
    edge = [0, 1, Q, Q - 1, (1 << 256) - 1][:n]
    t[:, :len(edge)] = limb.from_ints(edge, dev)
    return t.reshape(16, *shape)


def _segment(n: int, seed: int, dev, step: int = 1, first: int = 0):
    """(x, y, z) views of n lanes, each a slice (a row stride wider than n,
    lanes ``step`` apart from ``first``) of a wider plane."""
    return tuple(_strict_planes((first + step * n + 5,), seed + c, dev)[:, first::step][:, :n]
                 for c in range(3))


def _assemble_same(got, want, interleave):
    """P lanes, pads and the interleave's y and z word for word; the phi
    lanes' x after normalization, strict."""
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape and a.is_contiguous()
        if not interleave:
            assert all(torch.equal(a, b) for a, b in zip(g, w))
            continue
        assert torch.equal(g[0][..., 0::2], w[0][..., 0::2])
        assert torch.equal(g[1], w[1]) and torch.equal(g[2], w[2])
        phi = g[0][..., 1::2]
        assert int(phi.min()) >= 0 and int(phi.max()) <= limb.MASK
        assert torch.equal(limb.normalize(phi.reshape(16, -1)),
                           limb.normalize(w[0][..., 1::2].reshape(16, -1)))


# (outputs, K, groups an entry, lanes, interleave): msm_many's stacks of 1-4
# groups whose counts are not powers of two; fold's and complete_square's
# two padded bases; bv_split's stride-2 halves of an odd count; lockstep's
# 16 x 16
ASSEMBLE_CASES = [(1, 1, (3,), 16, True), (1, 2, (5, 11), 64, True),
                  (1, 3, (7, 1, 13, 2), 128, True), (2, 1, (13,), 16, False),
                  (2, 16, (11,), 16, False), (1, 1, (1000,), 1024, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,groups,L,interleave", ASSEMBLE_CASES)
def test_cuda_assemble_matches_plain_version(S, K, groups, L, interleave):
    dev = _card()
    outputs = [[[_segment(n - k % 2, 100 * s + 10 * k + g, dev, 1, g)
                 for g, n in enumerate(groups)] for k in range(K)] for s in range(S)]
    kernels.reset_counts()
    got = kernels.assemble(outputs, L, interleave)
    _assemble_same(got, kernels.assemble_plain(outputs, L, interleave), interleave)
    assert kernels.counts()["assemble"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [None, 4048])
def test_cuda_assemble_oracle_step_in_one_launch_or_split(monkeypatch, capacity):
    """msm_many's largest call, 130 entries of 4 groups, interleaved: one
    launch at the library's capacity, several when it is the pre-12.1
    parameter limit's (4,048 bytes): the same words either way."""
    dev = _card()
    outputs = [[[_segment(5 + (k + g) % 3, 1000 + 10 * k + g, dev, 1, g) for g in range(4)]
                for k in range(130)]]
    if capacity:
        monkeypatch.setattr(kernels, "assemble_capacity", lambda: capacity)
    kernels.reset_counts()
    got = kernels.assemble(outputs, 64, True)
    _assemble_same(got, kernels.assemble_plain(outputs, 64, True), True)
    assert (kernels.counts()["assemble"] > 1) == bool(capacity)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 31, 40])
def test_cuda_assemble_stride_two_halves(n):
    """bv_split's even and odd halves (lane stride 2) of an odd or even
    count, the odd padded to the even's count."""
    dev = _card()
    full = _segment(n, n, dev)
    halves = [[[tuple(c[:, s::2] for c in full)]] for s in (0, 1)]
    got = kernels.assemble(halves, (n + 1) // 2)
    _assemble_same(got, kernels.assemble_plain(halves, (n + 1) // 2), False)


def _tree_route(p):
    """The lane tree as the padd kernel ran it before reduce_lanes."""
    width = p[0].shape[-1]
    while width > 1:
        h = width // 2
        p = kernels.padd(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width = h
    return tuple(t[..., 0] for t in p)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("batch", [1, 3])
def test_cuda_reduce_lanes_matches_plain_version(L, batch):
    """B MSMs of L lanes (every 7th the identity; in MSM 0 lane t + L/2 the
    point of lane t, and in row 1 its digit with the other sign: the first
    level adds P and -P; row 2 the same sign: P + P; row 0 zero digits with
    sign 1): the fused kernel equal word for word to select_small + the
    padd kernel's tree and to select_small + the kernel's tree alone, and
    to its plain version after normalization; one launch.  Stopped after
    each level, equal to the plain version stopped there."""
    dev = _card()
    rows, h = 33, L // 2
    x, y, z = _points(batch * L, L + batch, dev)
    z[:, h:L] = limb.mul(z[:, :h], limb.from_ints([3] * h, dev))
    x[:, h:L] = limb.mul(x[:, :h], limb.from_ints([3] * h, dev))
    y[:, h:L] = limb.mul(y[:, :h], limb.from_ints([3] * h, dev))
    tabs = kernels.table_flat((x, y, z))
    rng = np.random.default_rng(L * batch)
    absd = torch.as_tensor(rng.integers(0, 9, size=(batch, rows, L)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(batch, rows, L)), dtype=torch.uint8, device=dev)
    absd[:, 0], sgn[:, 0] = 0, 1
    absd[0, 1:3, h:] = absd[0, 1:3, :h]
    sgn[0, 1, h:], sgn[0, 2, h:] = 1 - sgn[0, 1, :h], sgn[0, 2, :h]
    kernels.reset_counts()
    got = kernels.reduce_lanes(tabs, absd, sgn)
    assert kernels.counts()["reduce_lanes"] == 1
    assert all(g.shape == (16, batch, rows) for g in got)
    sel = kernels.select_small(tabs, absd, sgn)
    assert all(torch.equal(a, b) for a, b in zip(got, _tree_route(sel)))
    assert all(torch.equal(a, b) for a, b in zip(got, kernels.reduce_lanes_tree(sel)))
    assert _same(got, kernels.reduce_lanes_plain(tabs, absd, sgn))
    assert int(curve.normalize3(*got)[2, :, 0, 1].abs().sum()) == 0  # P + (-P): z = 0
    for levels in range(1, L.bit_length() - 1):
        assert _same(kernels.reduce_lanes(tabs, absd, sgn, levels=levels),
                     kernels.reduce_lanes_plain(tabs, absd, sgn, levels=levels))


@pytest.mark.cuda
def test_cuda_prove_assembles_and_reduces_through_the_kernels():
    """A 64bit prove on the card: golden bytes; assemble and reduce_lanes
    launched; one complete_square launch (its one square completion) and no
    endo, pneg or padd launch (phi, the negation and both sums are in it)."""
    import hashlib

    from bulletproofspp_tpu_torch import engine_profile
    from bulletproofspp_tpu_torch.core import range_proof as rpm
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    spec, setup, values = engine_profile._load("64bit")
    eng = TorchEngine(_card())
    kernels.reset_counts()
    proof = rpm.prove(setup, values, spec.random_seed.encode(), eng)
    _, proof_b = rpm.encode_proof(setup, proof)
    assert hashlib.sha256(proof_b).hexdigest() == (
        "fe39faef84b016b82b017a4ef07ba3f31c5237b0f79c0653376c86f5dbba8c5d")
    counts = kernels.counts()
    assert counts["assemble"] > 0 and counts["reduce_lanes"] > 0
    assert counts["complete_square"] == 1
    assert counts["endo"] == counts["pneg"] == counts["padd"] == 0
    # the MSMs select in reduce_lanes and store canonical in horner
    assert counts["select_small"] == counts["normalize3"] == 0
    assert kernels.shape_counts()["horner"] and all(
        "canonical" in shape for shape in kernels.shape_counts()["horner"])


def _msm_operands(batch: int, L: int, rows: int, seed: int, dev):
    """B MSMs of L lanes' flat tables (every 7th lane the identity; in MSM 0
    lane t + L/2 the point of lane t with another Z) and their (B, rows, L)
    uint8 digits: row 0 zero digits with sign 1, row 1 all 8, in MSM 0 row
    2 lane t + L/2 the digit of lane t with the other sign (the first level
    adds P and -P, lanes t and t + L/2 in every route's first level) and
    row 3 the same sign (P + P), the rest random.  Returns the (16, B, L)
    points too."""
    h = L // 2
    x, y, z = _points(batch * L, seed, dev)
    k = limb.from_ints([5] * h, dev)
    for c in (x, y, z):
        c[:, h:L] = limb.mul(c[:, :h], k)
    rng = np.random.default_rng(seed)
    absd = torch.as_tensor(rng.integers(0, 9, size=(batch, rows, L)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(batch, rows, L)), dtype=torch.uint8, device=dev)
    absd[:, 0], sgn[:, 0], absd[:, 1] = 0, 1, 8
    absd[0, 2:4, h:] = absd[0, 2:4, :h]
    sgn[0, 2, h:], sgn[0, 3, h:] = 1 - sgn[0, 2, :h], sgn[0, 3, :h]
    return (x, y, z), kernels.table_flat((x, y, z)), absd, sgn


@pytest.mark.cuda
@pytest.mark.parametrize("L", [128, 256, 512])
@pytest.mark.parametrize("batch", [1, 2])
def test_cuda_first_level_select_equals_select_small_and_the_unfused_kernels(batch, L):
    """msm's route from 128 to 1,023 lanes with the select in its first
    launch: reduce_block (L = 256, 512; both designs, and at B = 2 the
    wrapper's wide one: 8,448 output lanes) and tail_horner (L = 128, and
    its canonical stores) from the tables and the uint8 digits, equal word
    for word to select_small + the same kernel on the selected planes; one
    launch each; the whole route (msm.msm) canonical equal to normalize3 of
    the unfused route, and to the plain version."""
    from bulletproofspp_tpu_torch.ops import msm

    dev = _card()
    rows = 33
    pts, tabs, absd, sgn = _msm_operands(batch, L, rows, 7 * L + batch, dev)
    sel = kernels.select_small(tabs, absd, sgn)
    flat = tuple(t.reshape(16, -1) for t in sel)
    kernels.reset_counts()
    if L == 128:
        planes = tuple(t.reshape(16, batch, rows * 128) for t in sel)
        got = kernels.tail_horner(tabs, rows, absd=absd, sgn=sgn)
        assert all(torch.equal(a, b) for a, b in zip(got, kernels.tail_horner(planes, rows)))
        canon = kernels.tail_horner(tabs, rows, canonical=True, absd=absd, sgn=sgn)
        assert torch.equal(canon, curve.normalize3(*got))
        assert kernels.shape_counts()["tail_horner"] == {
            f"K={batch} tables": 1, f"K={batch}": 1, f"K={batch} tables canonical": 1}
        route = got
    else:
        f = L // 128
        wide = batch * rows * L // f >= kernels.REDUCE_BLOCK_WIDE_LANES
        assert wide == (batch == 2)
        for narrow in (True, False):
            got = kernels.reduce_block_design(tabs, f, narrow, absd, sgn)
            want = kernels.reduce_block_design(flat, f, narrow)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), narrow
        kernels.reset_counts()
        got = kernels.reduce_block(tabs, f, absd=absd, sgn=sgn)
        design = "wide" if wide else "narrow"
        assert kernels.shape_counts()["reduce_block"] == {
            f"W={batch * rows * L} f={f} tables {design}": 1}
        route = kernels.tail_horner(tuple(t.reshape(16, batch, rows * 128) for t in got), rows)
    planes = tuple(c.reshape(16, batch, L) for c in pts)
    got = msm.msm(*planes, absd, sgn, canonical=True)
    assert torch.equal(got, curve.normalize3(*route))
    cpu = (*(t.cpu() for t in planes), absd.cpu(), sgn.cpu())
    assert torch.equal(got.cpu(), msm.msm(*cpu, canonical=True))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 130])
def test_cuda_canonical_stores_equal_normalize3_of_the_kernels(batch):
    """horner and tail_horner with ``canonical``: one stacked (3, 16, B)
    tensor, word for word normalize3 of the projective stores, in the same
    one launch (an all-identity row and a cancelling row among the rows)."""
    dev = _card()
    r = _points(batch * 33, 80 + batch, dev, (16, batch, 33))
    for c, v in zip(r, (0, 1, 0)):
        c[:, :, 4] = limb.from_ints([v] * batch, dev).reshape(16, batch)
    kernels.reset_counts()
    got = kernels.horner(*r, canonical=True)
    assert kernels.counts()["horner"] == 1 and got.shape == (3, 16, batch)
    assert torch.equal(got, kernels.normalize3(*kernels.horner(*r)))
    assert torch.equal(got.cpu(), kernels.horner_plain(*(t.cpu() for t in r), canonical=True))
    p = _tail_lanes(batch, 33, 90 + batch, dev)
    got = kernels.tail_horner(p, 33, canonical=True)
    assert got.shape == (3, 16, batch)
    assert torch.equal(got, kernels.normalize3(*kernels.tail_horner(p, 33)))
    assert int(got.min()) >= 0 and int(got.max()) <= limb.MASK
