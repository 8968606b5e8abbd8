"""The engine's entry assembly and the small-MSM lane tree: ``kernels.assemble``
(``csrc/lanes.cu``) and ``kernels.reduce_lanes`` (``csrc/kernels.cu``).

On the CPU each plain version against the JAX function it replaces, on the
same numpy-seeded limb planes, exactly:

  * ``assemble_plain`` against ``_assemble_many_body``
    (``bulletproofspp_tpu/ops/engine.py:186``) for K = 1, 2 and 5 entries
    of 1-3 groups whose active counts are not powers of two: the P lanes,
    the interleave's y and z and the identity pads word for word, the phi
    lanes' x after normalization; against ``_assemble_fold`` (:159) word
    for word; ``TorchEngine.bv_pad`` / ``bv_split`` against the JAX
    engine's (``_dp_pad``, ``_split3``) word for word.  Inputs hold the
    edge values of ``test_torch_affine.EDGE`` (0, Q, Q +- 1, values in
    [Q, 2^256), saturated limbs) and identity lanes.
  * ``reduce_lanes_plain`` (the fused route: ``reduce_lanes_tree_plain``
    over ``select_plain``) against the JAX package's ``_table``, its one-hot
    select (``msm.py:140-156``: entry |d| of X and Z, |d| + 9 s of Y) and
    ``_reduce_lanes`` (``ops/msm.py:81``) after affine conversion, and
    against host integers, at L = 2 to 64 and B = 1, 2 and 6 MSMs (the JAX
    package adds neighbouring lanes, radix 8, so its projective words
    differ); ``reduce_lanes_tree_plain`` the same way on selected lanes, and
    both word for word against the lane loop ``ops/msm.py`` ran before (padd
    a level).  Inputs are points on the curve: multiples of G with random Z,
    identity lanes, rows that cancel (P + (-P)), rows that double (P + P)
    and rows of zero digits with sign 1.
  * assemble's by-value segment table (``_assemble_launches``): its layout,
    its records against the source's, its tiers, and the split into
    launches by entries (130 entries of 4 segments under the pre-12.1
    parameter limit) against one unsplit table; no pinned memory and no
    host-to-device copy on any call.
  * The slice as a whole on ``TorchEngine("cpu")``: 32bit and 64bit proof
    bytes equal to the golden digests, through both wrappers;
    ``msm_many``, ``fold_bv``, ``complete_square`` and their lockstep forms
    equal to ``HostEngine``'s.

On the CPU the wrappers run their plain versions (the tensors lie on the
CPU); the CUDA kernels are held against them in ``tests/test_torch_cuda.py``
(``cuda``-marked) and ``chip_smoke.py`` phase 16.
"""

import ctypes
import hashlib
import types

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch import bounds, engine_profile
from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.fields import Q, R
from bulletproofspp_tpu_torch.ops import curve, kernels, limb
from bulletproofspp_tpu_torch.ops.engine import DevicePoints, TorchEngine
from test_golden import GOLDEN  # noqa: E402
from test_torch_lane_ops import _canon, _canon_jax, _jax, _planes, _port  # noqa: E402


def _groups(counts, seed: int, extra: int = 3) -> list:
    """Numpy (3, 16, n + extra) planes a group: ``_planes`` (edge values,
    identity lanes) wider than its active count n."""
    return [_planes((n + extra,), seed + 17 * i) for i, n in enumerate(counts)]


def _same_assembly(got, want, interleave: bool):
    """Port (16, K, L) planes against the JAX package's (K, 16, L): word for
    word, but for the phi lanes' x (odd lanes), held after normalization."""
    for c, (g, w) in enumerate(zip(got, want)):
        g = limb.planes_to_numpy(g)
        w = np.asarray(w).transpose(1, 0, 2)
        assert g.shape == w.shape
        if interleave and c == 0:
            assert np.array_equal(g[..., 0::2], w[..., 0::2])
            assert np.array_equal(_canon(torch.from_numpy(g[..., 1::2].astype(np.int64))),
                                  np.asarray(_canon_jax(_jax("ops.limb"), w[..., 1::2])))
        else:
            assert np.array_equal(g, w)


ENTRIES = {  # K entries of 1-3 groups; active counts not powers of two
    1: [(5,)],
    2: [(3, 9), (13,)],
    5: [(1,), (7, 2, 5), (11,), (6, 3), (15,)],
}


@pytest.mark.parametrize("K", sorted(ENTRIES))
def test_assemble_plain_equals_the_jax_package_many_body(K):
    """msm_many's one launch: slices to the active counts, concatenated,
    [P, phi(P)] interleaved and padded to the lane bucket, K entries
    stacked (``_assemble_many_body``, the body of ``_msm_many_norm``)."""
    jengine = _jax("ops.engine")
    entries = ENTRIES[K]
    arrays = [_groups(counts, 100 * K + k) for k, counts in enumerate(entries)]
    L = 2 * max(1 << (sum(c) - 1).bit_length() for c in entries)
    parts = tuple(tuple(a) for groups in arrays for a in groups)
    want = jengine._assemble_many_body(parts, tuple(tuple(c) for c in entries), L)
    segs = [[tuple(t[:, :n] for t in _port(a)) for a, n in zip(groups, counts)]
            for groups, counts in zip(arrays, entries)]
    got, = kernels.assemble_plain([segs], L, interleave=True)
    _same_assembly(got, want, True)
    again, = kernels.assemble([segs], L, interleave=True)  # the wrapper on the CPU
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("N,n,L", [(1, 16, 16), (2, 13, 16), (4, 40, 64)])
def test_assemble_plain_equals_the_jax_fold_assembly(N, n, L):
    """The lockstep fold's two stacks (``_assemble_fold``): every prover's
    even and odd bases padded to L and stacked, in one call of two
    outputs."""
    jengine = _jax("ops.engine")
    evens = [_planes((n,), 10 * N + b) for b in range(N)]
    odds = [_planes((n,), 10 * N + b + 5) for b in range(N)]
    want = jengine._assemble_fold(tuple((tuple(e), tuple(o)) for e, o in zip(evens, odds)), L)
    got = kernels.assemble_plain([[[_port(e)] for e in evens], [[_port(o)] for o in odds]], L)
    _same_assembly(got[0], want[:3], False)
    _same_assembly(got[1], want[3:], False)


@pytest.mark.parametrize("n", [1, 2, 13, 31, 40])
def test_bv_pad_and_bv_split_equal_the_jax_package(n):
    """``bv_pad`` (``_dp_pad``) to the next bucket and ``bv_split``
    (``_split3``, the odd half padded to the even's count) word for word;
    the halves are read where they lie (stride 2)."""
    jengine = _jax("ops.engine")
    arr = _planes((n,), n)
    jeng = jengine.JaxEngine(host_below=0)
    jbv = jengine.DevicePoints(*arr)
    bv = DevicePoints(*_port(arr))
    eng = TorchEngine("cpu")
    m = 16 if n < 16 else 64
    for got, want in ((eng.bv_pad(bv, m), jeng.bv_pad(jbv, m)),
                      *zip(eng.bv_split(bv), jeng.bv_split(jbv))):
        for g, w in zip(got.coords(), (want.x, want.y, want.z)):
            assert np.array_equal(limb.planes_to_numpy(g), np.asarray(w))
            assert g.is_contiguous()


def _curve_lanes(shape, seed: int):
    """(16, *shape) projective lanes on the curve, last axis L: multiples of
    G with random Z, every 5th lane the identity; in row 1 of every MSM lane
    t + L/2 is -(lane t) (the first level cancels), in row 2 lane t + L/2 is
    lane t with another Z (the first level doubles).  Returns the port's
    planes and numpy uint32 planes of the same lanes."""
    rng = np.random.default_rng(seed)
    batch, rows, L = shape
    pts = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=32)]
    lanes = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        lanes[idx] = None if rng.integers(0, 5) == 0 else pts[int(rng.integers(0, len(pts)))]
    h = L // 2
    if L > 1:
        for b in range(batch):
            lanes[b, 1, h:] = [None if p is None else ec.neg(p) for p in lanes[b, 1, :h]]
            lanes[b, 2, h:] = lanes[b, 2, :h]
    cols = ([], [], [])
    for p in lanes.reshape(-1):
        z = int(rng.integers(1, 2**62)) << 190
        coords = (0, z % Q, 0) if p is None else (p[0] * z % Q, p[1] * z % Q, z % Q)
        for c, v in zip(cols, coords):
            c.append(v)
    arr = np.stack([limb.pack_ints(c).reshape(16, *shape) for c in cols])
    return _port(arr), arr


def _affine(x, y, z) -> list:
    """Projective (16, ...) numpy planes -> affine points / None."""
    xs, ys, zs = (limb.unpack_ints(np.asarray(t).reshape(16, -1)) for t in (x, y, z))
    out = []
    for a, b, c in zip(xs, ys, zs):
        c %= Q
        out.append(None if c == 0 else (a * pow(c, -1, Q) % Q, b * pow(c, -1, Q) % Q))
    return out


FUSED_LANES = 6 * 64  # one JAX table width for every case (the table is lane-wise)
FUSED_CASES = [(B, L) for L in (2, 4, 8, 16, 32, 64) for B in (1, 2, 6)]


@pytest.fixture(scope="module")
def jax_table():
    """msm._table over FUSED_LANES lanes, the case's lanes first (one
    compile for every case)."""
    jmsm = _jax("ops.msm")

    def table(arr):
        n = arr.shape[-1]
        full = np.zeros((3, 16, FUSED_LANES), np.uint32)
        full[1, 0] = 1  # identity filler
        full[..., :n] = arr
        return tuple(np.asarray(t)[..., :n] for t in jmsm._table(*full))

    return table


def _msm_case(batch: int, L: int, seed: int):
    """B MSMs of L base lanes and their (B, 33, L) digits: bases multiples of
    G with random Z, every 5th lane the identity, in MSM 0 lane t + L/2 the
    point of lane t with another Z; digits random, row 0 zero with sign 1,
    in MSM 0 row 1 lane t + L/2 the digit of lane t with the other sign (the
    first level adds P and -P) and row 2 with the same sign (P + P).
    Returns numpy (3, 16, B L) planes, the affine bases and the digits."""
    rng = np.random.default_rng(seed)
    pts = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=24)]
    lanes = [None if rng.integers(0, 5) == 0 else pts[int(rng.integers(0, len(pts)))]
             for _ in range(batch * L)]
    h = L // 2
    lanes[h:L] = lanes[:h]
    cols = ([], [], [])
    for pt in lanes:
        z = int(rng.integers(1, 2**62)) << 190
        coords = (0, z % Q, 0) if pt is None else (pt[0] * z % Q, pt[1] * z % Q, z % Q)
        for c, v in zip(cols, coords):
            c.append(v)
    arr = np.stack([limb.pack_ints(c) for c in cols])
    absd = rng.integers(0, 9, size=(batch, 33, L))
    sgn = rng.integers(0, 2, size=(batch, 33, L))
    absd[:, 0], sgn[:, 0] = 0, 1
    absd[0, 1:3, h:] = absd[0, 1:3, :h]
    sgn[0, 1, h:], sgn[0, 2, h:] = 1 - sgn[0, 1, :h], sgn[0, 2, :h]
    return arr, lanes, absd.astype(np.uint8), sgn.astype(np.uint8)


@pytest.mark.parametrize("B,L", FUSED_CASES)
def test_reduce_lanes_plain_equals_the_jax_package_after_affine_conversion(jax_table, B, L):
    """The fused route (select by digit, then the lane tree) against the JAX
    package's _table, one-hot select (numpy indexing: entry |d| of X and
    Z, |d| + 9 s of Y) and _reduce_lanes, after affine conversion, and
    against sum_l (-1)^s |d| P_l in host integers; the wrapper on the CPU
    gives the same words."""
    jmsm = _jax("ops.msm")
    arr, lanes, absd, sgn = _msm_case(B, L, 1000 * B + L)
    tables = kernels.table_flat_plain(_port(arr))
    ad, sg = torch.from_numpy(absd), torch.from_numpy(sgn)
    got = kernels.reduce_lanes_plain(tables, ad, sg)
    assert all(t.shape == (16, B, 33) for t in got)
    assert all(torch.equal(a, b) for a, b in zip(kernels.reduce_lanes(tables, ad, sg), got))
    tx, ty2, tz = jax_table(arr)
    lane = np.broadcast_to(np.arange(B)[:, None, None] * L + np.arange(L), absd.shape)
    sel = (tx[:, absd, lane], ty2[:, absd + 9 * sgn, lane], tz[:, absd, lane])
    want = jmsm._reduce_lanes(sel, L)
    got_affine = _affine(*(limb.planes_to_numpy(t) for t in got))
    assert got_affine == _affine(*want)
    mults = [[None] + [ec.scalar_mul(d, pt) for d in range(1, 9)] for pt in lanes]
    sums = []
    for b in range(B):
        for r in range(33):
            acc = None
            for i in range(L):
                m = mults[b * L + i][absd[b, r, i]]
                acc = ec.add(acc, ec.neg(m) if sgn[b, r, i] else m)
            sums.append(acc)
    assert got_affine == sums
    assert sums[0] is None and sums[1] is None  # zero digits; the cancelling row


@pytest.mark.parametrize("L", [2, 16, 64])
def test_reduce_lanes_tree_plain_equals_the_jax_package_after_affine_conversion(L):
    """The tree alone on selected lanes (reduce_lanes_tree_plain) against
    _reduce_lanes and host integers."""
    jmsm = _jax("ops.msm")
    p, arr = _curve_lanes((2, 3, L), L)
    got = kernels.reduce_lanes_tree_plain(p)
    assert all(t.shape == (16, 2, 3) for t in got)
    want = jmsm._reduce_lanes(tuple(arr), L)
    assert _affine(*(limb.planes_to_numpy(t) for t in got)) == _affine(*want)
    sums = [ec.msm_host([1] * L, [q for q in row]) for row in
            (_affine(*(a[:, b, r] for a in arr)) for b in range(2) for r in range(3))]
    assert _affine(*(limb.planes_to_numpy(t) for t in got)) == sums
    assert sums[1] is None and sums[4] is None  # the cancelling rows


def _padd_loop(sel, L):
    width = L
    while width > 1:
        h = width // 2
        sel = curve.padd(tuple(t[..., :h] for t in sel), tuple(t[..., h:] for t in sel))
        width = h
    return tuple(t[..., 0] for t in sel)


@pytest.mark.parametrize("L", [2, 16, 64])
def test_reduce_lanes_plain_equals_the_padd_loop_word_for_word(L):
    """The lane loop ops/msm.py ran before reduce_lanes (curve.padd a level,
    lane t plus lane t + h) over select_small's output gives the same words
    as the fused route, and over selected lanes as the tree alone; the
    wrappers on the CPU too.  levels stops after that many levels."""
    p, _ = _curve_lanes((3, 4, L), 7 * L)
    got = kernels.reduce_lanes_tree_plain(p)
    assert all(torch.equal(a, b) for a, b in zip(got, _padd_loop(p, L)))
    assert all(torch.equal(a, b) for a, b in zip(kernels.reduce_lanes_tree(p), got))
    arr, _, absd, sgn = _msm_case(3, L, 5 * L)
    tables = kernels.table_flat_plain(_port(arr))
    ad, sg = torch.from_numpy(absd), torch.from_numpy(sgn)
    want = _padd_loop(kernels.select_small(tables, ad, sg), L)
    assert all(torch.equal(a, b) for a, b in zip(kernels.reduce_lanes(tables, ad, sg), want))
    first = kernels.reduce_lanes_plain(tables, ad, sg, levels=1)
    sel = kernels.select_plain(tables, ad, sg)
    assert all(torch.equal(a, b[..., 0]) for a, b in zip(first, kernels.padd_plain(
        tuple(t[..., :L // 2] for t in sel), tuple(t[..., L // 2:] for t in sel))))


@pytest.mark.parametrize("shape", [(16, 2, 33, 128), (16, 2, 33, 24), (16, 33, 16), (16, 1, 1, 1)])
def test_reduce_lanes_refuses_other_shapes(shape):
    t = torch.zeros(shape, dtype=torch.int64)
    with pytest.raises(ValueError, match="reduce_lanes"):
        kernels.reduce_lanes_tree((t, t, t))
    if len(shape) == 4:
        d = torch.zeros(shape[1:], dtype=torch.uint8)
        tabs = tuple(torch.zeros((r, shape[1] * shape[3]), dtype=torch.int64)
                     for r in (144, 288, 144))
        with pytest.raises(ValueError, match="reduce_lanes"):
            kernels.reduce_lanes(tabs, d, d)
    with pytest.raises(ValueError, match="levels"):
        kernels.reduce_lanes_tree(tuple(torch.zeros((16, 1, 1, 16), dtype=torch.int64)
                                        for _ in range(3)), levels=5)


def test_assemble_refuses_what_does_not_fit():
    seg = tuple(torch.zeros((16, 9), dtype=torch.int64) for _ in range(3))
    with pytest.raises(ValueError, match="does not fit"):
        kernels.assemble([[[seg]]], 16, interleave=True)  # 9 lanes > 16 / 2
    with pytest.raises(ValueError, match="same number"):
        kernels.assemble([[[seg]], []], 16)
    with pytest.raises(ValueError, match="even"):
        kernels.assemble([[[seg]]], 17, interleave=True)


class _Guard:
    def __init__(self, dev):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _stub_card(monkeypatch, seen, capacity=32712):
    """Stubbed libraries recording (entry, arguments past the pointers, and
    for assemble the table's bytes, read during the call), a device check
    that places meta tensors on the card, and torch.cuda's guard and
    stream."""
    def entry(name):
        def call(*args):
            if name == "bppp_assemble":
                seen.append((name, args[5:-1], ctypes.string_at(args[0], args[1])))
            else:
                seen.append((name, args[8:-1]))
            return 0
        return call

    lib = types.SimpleNamespace(**{k.entry: entry(k.entry) for k in kernels.KERNELS.values()},
                                bppp_assemble_capacity=lambda: capacity)
    monkeypatch.setattr(kernels, "lib", lambda: {src: lib for src in kernels.SOURCES})
    monkeypatch.setattr(kernels, "_check", lambda *p, contiguous=True: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))


def _decode(table: bytes, n_entries: int):
    """A launch's table -> (starts, records): csrc/lanes.cu: AssembleTable."""
    buf = np.frombuffer(table, dtype=np.uint8)
    off = (4 * (n_entries + 1) + 7) // 8 * 8
    assert (len(buf) - off) % kernels._SEG.itemsize == 0
    return buf[:4 * (n_entries + 1)].view(np.int32).tolist(), buf[off:].view(kernels._SEG)


def test_wrappers_pass_the_segment_table_and_shapes(monkeypatch):
    """The C entries' arguments on meta tensors placed on the card by a
    stubbed device check: assemble's table by value (starts, then each
    segment's x, y and z addresses with its first lane, row and lane
    strides, count and first lane in its entry; a slice and a stride-2
    half read in place), its first entry, entry count, K, L and flag; reduce_lanes' batch, rows, L, levels and route
    (tables or planes); the outputs' shapes and their launch shapes."""
    seen = []
    _stub_card(monkeypatch, seen)
    kernels.reset_counts()
    big = torch.zeros((16, 40), dtype=torch.int64, device="meta")
    sliced = (big[:, 3:10], big[:, 0::2][:, :7], big[:, :7])
    out = kernels.assemble([[[sliced, (big[:, :2],) * 3], [sliced]]], 32, interleave=True)
    assert len(out) == 1 and all(t.shape == (16, 2, 32) and t.is_contiguous() for t in out[0])
    starts, rec = _decode(seen[-1][2], 2)
    assert starts == [0, 2, 3] and len(seen[-1][2]) == 16 + 3 * 56
    assert rec["c"].tolist() == [[24, 0, 0], [0, 0, 0], [24, 0, 0]]
    assert rec["rs"].tolist() == [[40, 40, 40]] * 3
    assert rec["ls"].tolist() == [[1, 2, 1], [1, 1, 1], [1, 2, 1]]
    assert rec["n"].tolist() == [7, 2, 7] and rec["first"].tolist() == [0, 7, 0]
    halves = kernels.assemble([[[tuple(c[:, s::2] for c in (big,) * 3)]] for s in (0, 1)], 20)
    assert [tuple(t.shape) for h in halves for t in h] == [(16, 1, 20)] * 6
    starts, rec = _decode(seen[-1][2], 2)
    assert starts == [0, 1, 2] and len(seen[-1][2]) == 16 + 2 * 56
    assert rec["c"].tolist() == [[0, 0, 0], [8, 8, 8]]
    assert (rec["rs"].tolist(), rec["ls"].tolist(), rec["n"].tolist(),
            rec["first"].tolist()) == ([[40] * 3] * 2, [[2] * 3] * 2, [20, 20], [0, 0])
    p = tuple(torch.zeros((16, 6, 33, 16), dtype=torch.int64, device="meta") for _ in range(3))
    tabs = tuple(torch.zeros((r, 6 * 16), dtype=torch.int64, device="meta")
                 for r in (144, 288, 144))
    d = torch.zeros((6, 33, 16), dtype=torch.uint8, device="meta")
    assert [t.shape for t in kernels.reduce_lanes(tabs, d, d)] == [(16, 6, 33)] * 3
    assert [t.shape for t in kernels.reduce_lanes(tabs, d, d, levels=2)] == [(16, 6, 33)] * 3
    assert [t.shape for t in kernels.reduce_lanes_tree(p)] == [(16, 6, 33)] * 3
    with pytest.raises(ValueError, match="tables of 96 lanes"):
        kernels.reduce_lanes(tabs[:2] + (tabs[0][:, :80],), d, d)
    assert [(name, args) for name, args, *_ in seen] == [
        ("bppp_assemble", (0, 2, 2, 32, 1)), ("bppp_assemble", (0, 2, 1, 20, 0)),
        ("bppp_reduce_lanes", (6, 33, 16, 4, 1)), ("bppp_reduce_lanes", (6, 33, 16, 2, 1)),
        ("bppp_reduce_lanes", (6, 33, 16, 4, 0))]
    assert kernels.shape_counts()["assemble"] == {"S=1 K=2 L=32 interleave": 1, "S=2 K=1 L=20": 1}
    assert kernels.shape_counts()["reduce_lanes"] == {"B=6 L=16": 1, "B=6 L=16 levels=2": 1,
                                                      "B=6 L=16 tree": 1}
    kernels.reset_counts()


def _oracle_step(K: int, groups: int, y_step: int = 1):
    """msm_many's largest call: K entries of ``groups`` slices of one meta
    base each (y read at lane stride ``y_step``, x and z at 1)."""
    big = torch.zeros((16, 4096), dtype=torch.int64, device="meta")
    ys = big[:, 0::y_step]
    return [[[(big[:, 7 * k + g:7 * k + g + 3], ys[:, g:g + 3], big[:, g:g + 3])
              for g in range(groups)] for k in range(K)]]


@pytest.mark.parametrize("y_step", [1, 2])
def test_assemble_table_splits_by_entries(y_step):
    """130 entries of 4 segments fit one launch at CUDA 12.1's parameter
    limit (32,712 bytes of table: 528 + 520 x 56); under the 4,096-byte
    limit (4,048) the launches take consecutive entries, each table at most
    the capacity, and each launch's starts and records are the unsplit
    table's for its entries (starts rebased).  The records carry y's own
    lane stride."""
    entries = kernels._assemble_segments(_oracle_step(130, 4, y_step), 32)
    (whole,) = kernels._assemble_launches(entries, 32712)
    assert whole[:2] == (0, 130)
    assert whole[2].nbytes == kernels._table_bytes(130, 520) == 528 + 520 * 56 == 29648
    starts, rec = _decode(whole[2].tobytes(), 130)
    assert starts == list(range(0, 521, 4))
    assert rec["ls"].tolist() == [[1, y_step, 1]] * 520
    split = kernels._assemble_launches(entries, 4048)
    assert len(split) >= -(-whole[2].nbytes // 4048) > 1
    assert [first for first, *_ in split] == list(np.cumsum([0] + [n for _, n, _ in split[:-1]]))
    assert sum(n for _, n, _ in split) == 130
    for first, n, table in split:
        assert table.nbytes <= 4048
        part_starts, part = _decode(table.tobytes(), n)
        lo, hi = starts[first], starts[first + n]
        assert part_starts == [v - lo for v in starts[first:first + n + 1]]
        assert part.tobytes() == rec[lo:hi].tobytes()
    with pytest.raises(ValueError, match="outgrows"):
        kernels._assemble_launches(kernels._assemble_segments(_oracle_step(1, 120), 400), 4048)


def test_assemble_host_tool_shapes():
    """tools/assemble_host's two calls: a fold's two bases to 16 lanes (a
    2-segment table, the smallest tier) and 130 entries of 4 segments to
    64 lanes interleaved (one launch at 32,712 bytes); both assemble."""
    from bulletproofspp_tpu_torch.tools import assemble_host

    calls = assemble_host.shapes(torch.device("cpu"))
    assert list(calls) == ["S=2 K=1 L=16", "S=1 K=130 L=64 interleave"]
    sizes = []
    for outputs, L, interleave in calls.values():
        entries = kernels._assemble_segments(outputs, L // 2 if interleave else L)
        (launch,) = kernels._assemble_launches(entries, 32712)
        sizes.append(launch[2].nbytes)
        out = kernels.assemble(outputs, L, interleave)
        assert [t.shape for o in out for t in o] == [(16, len(outputs[0]), L)] * 3 * len(outputs)
    assert sizes == [16 + 2 * 56, 528 + 520 * 56]


def test_assemble_table_tiers_and_records_match_the_source():
    """ops/kernels.py's record and tiers are csrc/lanes.cu's: Seg 56 bytes,
    tiers 256 and 2,048 bytes and the largest the
    parameter limit less the 48-byte header (32,764 from CUDA 12.1, else
    4,096); the commonest calls (2-3 segments) fit the smallest tier."""
    import re

    with open(f"{kernels.CSRC}/lanes.cu") as f:
        text = f.read()
    assert "sizeof(Seg) == 56" in text and kernels._SEG.itemsize == 56
    tiers = re.search(r"kTiers\[3\] = \{(\d+), (\d+), kMaxTable\}", text).groups()
    assert tuple(int(t) for t in tiers) == (256, 2048)
    limits = [int(v) for v in re.findall(r"constexpr int kParamLimit = (\d+);", text)]
    assert limits == [32764, 4096] and [(v - 48) // 8 * 8 for v in limits] == [32712, 4048]
    for n_entries, n_segs in ((2, 2), (1, 3), (2, 3)):
        assert kernels._table_bytes(n_entries, n_segs) <= 256


def test_assemble_makes_no_pinned_buffer_and_no_host_to_device_copy(monkeypatch):
    """assemble on tensors placed on the card: no pin_memory, no .to / copy_
    / .cuda of any tensor, whether the call takes one launch or (a forced
    split) several; each launch counted."""
    seen = []
    _stub_card(monkeypatch, seen, capacity=4048)

    def refuse(*a, **k):
        raise AssertionError("assemble made a host-to-device copy")

    for name in ("pin_memory", "to", "copy_", "cuda"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    kernels.reset_counts()
    kernels.assemble(_oracle_step(130, 4), 64, interleave=True)
    n = kernels.counts()["assemble"]
    assert n == len(seen) > 1 and all(len(t) <= 4048 for *_, t in seen)
    assert kernels.shape_counts()["assemble"] == {"S=1 K=130 L=64 interleave": n}
    kernels.assemble([[[tuple(c[:, :13] for c in _oracle_step(1, 1)[0][0][0])]]] * 2, 16)
    assert kernels.counts()["assemble"] == n + 1
    kernels.reset_counts()


def test_work_counts():
    assert bounds.assemble(24, 64, True) == (24 * bounds.FE_MUL, 88 * 384)
    assert bounds.assemble(13, 16, False) == (0, 29 * 384)
    absd = torch.zeros((2, 33, 16), dtype=torch.uint8)
    sgn = torch.zeros_like(absd)
    absd[:, 1:] = 3
    # the select's reads (entries 0 and 3 of X and Z, Y at 0 and 3), the
    # digits (a byte each), the row sums out
    assert bounds.reduce_lanes(absd, sgn) == (2 * 33 * 15 * bounds.PT_ADD,
                                              2 * 16 * 6 * 128 + absd.numel() * 2 + 2 * 33 * 384)
    assert bounds.reduce_lanes_tree(2, 33, 16) == (2 * 33 * 15 * bounds.PT_ADD,
                                                   2 * 33 * 17 * 384)
    assert bounds.reduce_lanes_chain(64) == (6, 12)


def _affine_points(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [None if i % 6 == 4 else ec.scalar_mul(int(rng.integers(1, 2**62)) << 64, ec.G)
            for i in range(n)]


def test_engine_calls_equal_host_engine():
    """msm_many (entries of several groups, base vectors sliced by their
    scalars' counts and one empty entry), fold_bv, complete_square, bv_split
    and their lockstep forms on TorchEngine("cpu"), equal to HostEngine's."""
    rng = np.random.default_rng(16)
    eng, host = TorchEngine("cpu"), HostEngine()
    a, b, c = _affine_points(13, 1), _affine_points(40, 2), _affine_points(7, 3)
    bva, bvb, bvc = (eng.basevec(v) for v in (a, b, c))

    def scalars(n):
        return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]

    s = [scalars(n) for n in (11, 40, 5, 7)]
    got = eng.msm_many([[(s[0], bva), (s[1], bvb)], [], [(s[2], bvc), (s[3], bva)]])
    want = host.msm_many([[(s[0], a), (s[1], b)], [], [(s[2], c), (s[3], a)]])
    assert got == want and got[1] is None
    even, odd = eng.bv_split(bvb)
    heven, hodd = host.bv_split(b)
    assert even.to_host() == heven and odd.to_host() == hodd
    k, r = 3**70, 5**50  # fold scalars: GLV halves, under 2^128
    assert eng.fold_bv(k, -r, even, odd).to_host() == host.fold_bv(k, -r, heven, hodd)
    gx, hy = eng.complete_square(r, bva, bvc)
    assert (gx.to_host(), hy.to_host()) == host.complete_square(r, a, c + [None] * 6)
    folds = eng.fold_bv_many([(k, r, even, odd), (r, -k, odd, even)])
    assert [f.to_host() for f in folds] == [host.fold_bv(k, r, heven, hodd),
                                            host.fold_bv(r, -k, hodd, heven)]
    squares = eng.complete_square_many([(r, bva, bvc), (k, bva, eng.basevec(a))])
    assert [(g.to_host(), h.to_host()) for g, h in squares] == [
        host.complete_square(r, a, c + [None] * 6), host.complete_square(k, a, a)]


@pytest.mark.parametrize("name", ["32bit", "64bit"])
def test_proof_bytes_on_the_cpu_through_both_wrappers(monkeypatch, name):
    """A prove on TorchEngine("cpu") through counting stubs on
    kernels.assemble and kernels.reduce_lanes: both reached, and the proof
    and commitment bytes equal the golden digests."""
    reached = {"assemble": 0, "reduce_lanes": 0}
    for wrapper in reached:
        inner = getattr(kernels, wrapper)

        def counted(*a, _inner=inner, _name=wrapper, **k):
            reached[_name] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(kernels, wrapper, counted)
    spec, setup, values = engine_profile._load(name)
    proof = rpm.prove(setup, values, spec.random_seed.encode(), TorchEngine("cpu"))
    coms_b, proof_b = rpm.encode_proof(setup, proof)
    assert (hashlib.sha256(proof_b).hexdigest(),
            hashlib.sha256(coms_b).hexdigest()) == GOLDEN[name][:2]
    assert all(reached.values()), reached
