"""The lane-wise functions of ``csrc/lanes.cu``: the small-MSM table select,
``endo`` (and the engine's [P, phi(P)] interleave), ``pneg`` and
``normalize3``.  On the CPU each plain version against the JAX function it
replaces on the same numpy-seeded limb planes, exactly: ``curve.endo``,
``ops/engine.py: _interleave_endo``, ``curve.pneg`` after normalization,
``curve._normalize3`` word for word, and ``msm._table``'s entries indexed
by |d| (X, Z) and |d| + 9 s (Y) against ``kernels.select_plain``.  Inputs
hold the edge values of ``test_torch_affine.EDGE`` (0, Q, Q +- 1, values in
[Q, 2^256), saturated limbs), the dropped-carry operand
(tests/test_ops_limb.py:160) and identity lanes.  A 64bit prove and verify
on ``TorchEngine("cpu")`` must reach endo and pneg, and select and
normalize inside reduce_lanes, tail_horner and horner, never through
select_small or normalize3.

The JAX package is imported inside the tests that compare with it, so the
file's CUDA case, each kernel against its plain version, also runs where
JAX is not installed (the machine with the card):

    python -m pytest --noconftest -m cuda tests/test_torch_lane_ops.py
"""

import collections
import hashlib
import importlib
import os
import re
import types

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch import bounds, engine_profile
from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.fields import Q
from bulletproofspp_tpu_torch.ops import curve, kernels, limb
from bulletproofspp_tpu_torch.ops.engine import TorchEngine, _interleave_endo
from test_torch_affine import EDGE  # noqa: E402

GOLDEN_64BIT = (  # tests/test_golden.py:45-46: proof, commitments
    "fe39faef84b016b82b017a4ef07ba3f31c5237b0f79c0653376c86f5dbba8c5d",
    "fd56b4b18729678d4f77a64644771f77ebaf38f686da8523a3fdebcb2d29c8ee")

DROPPED_CARRY = 94329926858193610711403129864407773699609837703255222953893265490612872160623
ROWS = 33


def _jax(module: str):
    """A module of the JAX package (the test skips where JAX is missing)."""
    pytest.importorskip("jax")
    return importlib.import_module(f"bulletproofspp_tpu.{module}")


def _values(n: int, seed: int, shift: int = 0) -> list:
    """EDGE and the dropped-carry operand (rotated by ``shift``), then
    numpy-seeded values over the full 256-bit range: n in all."""
    rng = np.random.default_rng(seed)
    edge = EDGE + [DROPPED_CARRY, (DROPPED_CARRY * DROPPED_CARRY) % Q]
    edge = edge[shift:] + edge[:shift]
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(max(0, n - len(edge)))]
    return (edge + rand)[:n]


def _planes(shape, seed: int) -> np.ndarray:
    """(3, 16, *shape) uint32 strict planes: x, y and z from ``_values``
    (each its own rotation), every 7th lane the identity (0 : 1 : 0)."""
    n = int(np.prod(shape))
    cols = [_values(n, seed + c, 3 * c) for c in range(3)]
    for j in range(3, n, 7):
        cols[0][j], cols[1][j], cols[2][j] = 0, 1, 0
    return np.stack([limb.pack_ints(v).reshape(16, *shape) for v in cols])


def _port(arr):
    return tuple(limb.planes_from_numpy(a, "cpu") for a in arr)


def _canon(t) -> np.ndarray:
    """A port plane (any batch shape), normalized, as uint32 numpy."""
    return limb.planes_to_numpy(limb.normalize(t))


def _canon_jax(jlimb, a) -> np.ndarray:
    return np.asarray(jlimb.normalize(a))


SHAPES = [(16,), (40,), (3, 16), (2, 40)]


@pytest.mark.parametrize("shape", SHAPES)
def test_endo_plain_equals_the_jax_package(shape):
    jcurve, jlimb = _jax("ops.curve"), _jax("ops.limb")
    arr = _planes(shape, 1)
    got = kernels.endo_plain(_port(arr))
    want = jcurve.endo(tuple(arr))
    for g, w in zip(got, want):
        assert np.array_equal(_canon(g), _canon_jax(jlimb, w))
    assert got[1] is not None and np.array_equal(limb.planes_to_numpy(got[1]), arr[1])
    xs = limb.unpack_ints(arr[0].reshape(16, -1))
    assert limb.unpack_ints(_canon(got[0]).reshape(16, -1)) == [ec.BETA * x % Q for x in xs]


@pytest.mark.parametrize("shape", SHAPES)
def test_interleave_endo_equals_the_jax_package(shape):
    """[P_i, phi(P_i)] along the last axis; the JAX function flattens the
    batch axes, which interleaves the last axis the same way."""
    jengine, jlimb = _jax("ops.engine"), _jax("ops.limb")
    arr = _planes(shape, 2)
    got = _interleave_endo(*_port(arr))
    want = jengine._interleave_endo(*(a.reshape(16, -1) for a in arr))
    for g, w in zip(got, want):
        assert g.shape == (16, *shape[:-1], 2 * shape[-1])
        assert np.array_equal(_canon(g).reshape(16, -1), _canon_jax(jlimb, w))
    assert torch.equal(got[1][..., 0::2], got[1][..., 1::2])
    assert np.array_equal(limb.planes_to_numpy(got[0][..., 0::2]), arr[0])


@pytest.mark.parametrize("shape", SHAPES)
def test_pneg_plain_equals_the_jax_package(shape):
    """-y mod p, strict; identity lanes stay identities (z = 0)."""
    jcurve, jlimb = _jax("ops.curve"), _jax("ops.limb")
    arr = _planes(shape, 3)
    got = kernels.pneg_plain(_port(arr))
    want = jcurve.pneg(tuple(arr))
    for g, w in zip(got, want):
        assert np.array_equal(_canon(g), _canon_jax(jlimb, w))
    assert int(got[1].max()) <= limb.MASK
    ys = limb.unpack_ints(arr[1].reshape(16, -1))
    assert limb.unpack_ints(_canon(got[1]).reshape(16, -1)) == [(-y) % Q for y in ys]


@pytest.mark.parametrize("shape", SHAPES + [(130,)])
def test_normalize3_plain_equals_the_jax_package_word_for_word(shape):
    jcurve = _jax("ops.curve")
    arr = _planes(shape, 4)
    got = kernels.normalize3_plain(*_port(arr))
    assert got.shape == (3, 16, *shape)
    assert np.array_equal(limb.planes_to_numpy(got), np.asarray(jcurve._normalize3(*arr)))
    assert torch.equal(curve.normalize3(*_port(arr)), got)
    for c in range(3):
        vals = limb.unpack_ints(arr[c].reshape(16, -1))
        assert limb.unpack_ints(limb.planes_to_numpy(got[c]).reshape(16, -1)) == [v % Q for v in vals]


def _digits(batch: int, L: int, seed: int):
    """(B, ROWS, L) uint8 magnitudes 0..8 and signs (the kernels' digits);
    row 0 all zero digits with sign 1."""
    rng = np.random.default_rng(seed)
    absd = rng.integers(0, 9, size=(batch, ROWS, L)).astype(np.uint8)
    sgn = rng.integers(0, 2, size=(batch, ROWS, L)).astype(np.uint8)
    absd[:, 0], sgn[:, 0] = 0, 1
    return absd, sgn


SELECT_LANES = 1024  # one JAX table over all the cases' lanes
SELECT_CASES = [(1, 16), (3, 64), (1, 128), (6, 16), (2, 512)]  # (B, L)


@pytest.fixture(scope="module")
def jax_tables():
    """msm._table of SELECT_LANES lanes (points, edge coordinates and
    identity lanes: the table is lane-wise and the same polynomials mod p on
    both sides), the lanes as numpy planes, and the port's flat tables."""
    jmsm = _jax("ops.msm")
    arr = _planes((SELECT_LANES,), 5)
    pts = [ec.scalar_mul(k, ec.G) for k in range(1, 40)]
    for j in range(0, SELECT_LANES, 5):  # a fifth of the lanes real points, Z scaled
        x, y = pts[j % len(pts)]
        z = (j + 2) << 200
        for c, v in enumerate((x * z % Q, y * z % Q, z % Q)):
            arr[c, :, j] = limb.pack_ints([v])[:, 0]
    tx, ty2, tz = (np.asarray(t) for t in jmsm._table(*arr))
    return (tx, ty2, tz), kernels.table_flat_plain(_port(arr))


@pytest.mark.parametrize("batch,L", SELECT_CASES)
def test_select_plain_equals_the_jax_tables_indexed_by_digit(jax_tables, batch, L):
    """Entry |d| of X and Z and |d| + 9 s of Y, of each (MSM, row, lane), from
    table lane b L + l: the JAX package's one-hot select (msm.py:145-156)."""
    jlimb = _jax("ops.limb")
    (tx, ty2, tz), flat = jax_tables
    n = batch * L
    absd, sgn = _digits(batch, L, batch * 1000 + L)
    got = kernels.select_plain(tuple(t[:, :n] for t in flat), torch.from_numpy(absd),
                               torch.from_numpy(sgn))
    lane = np.arange(batch)[:, None, None] * L + np.arange(L)[None, None, :]
    lane = np.broadcast_to(lane, absd.shape)
    want = (tx[:, absd, lane], ty2[:, absd + 9 * sgn, lane], tz[:, absd, lane])
    for g, w in zip(got, want):
        assert g.shape == (16, batch, ROWS, L)
        assert np.array_equal(_canon(g), _canon_jax(jlimb, w))
    assert all(torch.equal(a, b) for a, b in zip(
        kernels.select_small(tuple(t[:, :n] for t in flat), torch.from_numpy(absd),
                             torch.from_numpy(sgn)), got))


def test_lanes_source_holds_beta():
    """The beta words of lanes.cu's endo and assemble (and kernels.cu's
    complete_square), csrc/curve.cuh: fe_beta, are core.ec.BETA."""
    with open(os.path.join(kernels.CSRC, "curve.cuh")) as f:
        text = f.read()
    body = re.search(r"Fe fe_beta\(\) \{\s*const u32 w\[8\] = \{([^}]*)\}", text).group(1)
    words = [int(w.strip().rstrip("u"), 16) for w in body.split(",")]
    assert sum(w << (32 * k) for k, w in enumerate(words)) == ec.BETA


def test_lane_ops_work_counts():
    absd = torch.zeros((2, ROWS, 16), dtype=torch.uint8)
    sgn = torch.zeros_like(absd)
    absd[:, 1:] = 3
    n = absd.numel()
    # per lane: entry 0 and 3 of X and Z, Y at 0 and 3 (sign 0); a byte a digit
    assert bounds.select_small(absd, sgn) == (0, 2 * 16 * 6 * 128 + n * 2 + n * 384)
    assert bounds.endo(64, True) == (64 * bounds.FE_MUL, 64 * 3 * 384)
    assert bounds.endo(64, False) == (64 * bounds.FE_MUL, 64 * 2 * 128)
    assert bounds.pneg(64) == (64 * bounds.FE_SUB, 64 * 2 * 128)
    assert bounds.normalize3(6) == (0, 6 * 2 * 384)


def test_wrappers_launch_with_the_flattened_shapes(monkeypatch):
    """The C entries' lane counts and flags, on meta tensors placed on the
    card by a stubbed device check: endo with and without the interleave
    over (16, K, n) stacks, pneg and normalize3 over (16, K, n), the select
    over (B, ROWS, L) digits; the outputs' shapes."""
    seen = []

    def entry(name):
        def call(*args):
            seen.append((name, args[-3:-1] if name == "bppp_endo" else args[-2]))
            return 0
        return call

    lib = types.SimpleNamespace(**{k.entry: entry(k.entry) for k in kernels.KERNELS.values()})
    monkeypatch.setattr(kernels, "lib", lambda: {src: lib for src in kernels.SOURCES})
    monkeypatch.setattr(kernels, "_check", lambda *planes: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Guard())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    kernels.reset_counts()
    p = tuple(torch.zeros((16, 3, 40), dtype=torch.int64, device="meta") for _ in range(3))
    assert [t.shape for t in kernels.endo(p, interleave=True)] == [(16, 3, 80)] * 3
    bx, y, z = kernels.endo(p)
    assert bx.shape == (16, 3, 40) and y is p[1] and z is p[2]
    x, ny, z = kernels.pneg(p)
    assert x is p[0] and ny.shape == (16, 3, 40) and z is p[2]
    assert kernels.normalize3(*p).shape == (3, 16, 3, 40)
    tabs = tuple(torch.zeros((r, 6 * 16), dtype=torch.int64, device="meta") for r in (144, 288, 144))
    d = torch.zeros((6, ROWS, 16), dtype=torch.uint8, device="meta")
    assert [t.shape for t in kernels.select_small(tabs, d, d)] == [(16, 6, ROWS, 16)] * 3
    with pytest.raises(ValueError, match="tables of 96 lanes"):
        kernels.select_small(tabs[:2] + (tabs[0][:, :80],), d, d)
    assert seen == [("bppp_endo", (120, 1)), ("bppp_endo", (120, 0)), ("bppp_pneg", 120),
                    ("bppp_normalize3", 120), ("bppp_select_small", 16)]
    assert kernels.shape_counts()["endo"] == {"L=120 interleave": 1, "L=120": 1}
    assert kernels.shape_counts()["select_small"] == {"B=6 L=16": 1}
    kernels.reset_counts()


class _Guard:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_prove_and_verify_on_the_cpu_reach_the_four_wrappers(monkeypatch):
    """A 64bit prove and verify on TorchEngine("cpu") through counting stubs
    on kernels.select_small, endo, pneg and normalize3, and on the wrappers
    that took over their work: complete_square (phi and the negation of the
    square completion), assemble (msm_many's [P, phi(P)] interleave),
    reduce_lanes (the select under 128 lanes), reduce_block and tail_horner
    (their first level selects from 128 to 1,023 lanes) and horner (its
    canonical stores).  The prove reaches complete_square and neither endo
    nor pneg (no call site runs the plain limb functions directly); no MSM
    reaches select_small or normalize3; the bytes stay golden and the proof
    verifies.  The prove's MSMs are all under 128 lanes (reduce_lanes, then
    horner canonical); the verify's one MSM of 128 lanes selects in
    tail_horner, which stores it canonical."""
    names = ("select_small", "endo", "pneg", "normalize3", "complete_square", "assemble",
             "reduce_lanes", "reduce_block", "tail_horner", "horner")
    reached = {name: 0 for name in names}
    forms = collections.Counter()
    for name in reached:
        inner = getattr(kernels, name)

        def counted(*a, _inner=inner, _name=name, **k):
            reached[_name] += 1
            forms[_name, k.get("canonical", False), k.get("absd") is not None] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    spec, setup, values = engine_profile._load("64bit")
    eng = TorchEngine("cpu")
    proof = rpm.prove(setup, values, spec.random_seed.encode(), eng)
    coms_b, proof_b = rpm.encode_proof(setup, proof)
    assert (hashlib.sha256(proof_b).hexdigest(),
            hashlib.sha256(coms_b).hexdigest()) == GOLDEN_64BIT
    proved, proved_forms = dict(reached), dict(forms)
    assert rpm.verify(setup, rpm.decode_proof(setup, coms_b, proof_b, engine=eng), eng)
    assert reached["select_small"] == reached["normalize3"] == 0, reached
    assert proved["tail_horner"] == proved["reduce_block"] == 0, proved
    assert proved["endo"] == proved["pneg"] == 0, proved
    assert all(proved[k] for k in ("complete_square", "assemble", "reduce_lanes", "horner")), proved
    assert set(proved_forms) == {(k, False, False) for k in (
        "complete_square", "assemble", "reduce_lanes")} | {("horner", True, False)}
    assert forms["tail_horner", True, True] > 0 and reached["assemble"] > proved["assemble"], forms


@pytest.mark.cuda
def test_cuda_lane_ops_match_plain_versions():
    """On the card: each kernel against its plain version, select_small and
    normalize3 word for word, endo and pneg after normalization, at the main
    paths' shapes with edge lanes; one launch each call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    kernels.reset_counts()
    for shape in [(16,), (520,), (3, 16), (16, 16)]:
        p = tuple(t.to(dev) for t in _port(_planes(shape, 9)))
        for fn, plain in ((lambda q: kernels.endo(q, interleave=True),
                           lambda q: kernels.endo_plain(q, interleave=True)),
                          (kernels.endo, kernels.endo_plain), (kernels.pneg, kernels.pneg_plain)):
            for g, w in zip(fn(p), plain(p)):
                assert torch.equal(limb.normalize(g), limb.normalize(w))
                assert int(g.max()) <= limb.MASK
        assert torch.equal(kernels.normalize3(*p), kernels.normalize3_plain(*p))
    for batch, L in ((1, 16), (6, 64), (2, 512)):
        p = tuple(t.to(dev) for t in _port(_planes((batch * L,), batch + L)))
        tabs = kernels.table_flat(p)
        absd, sgn = (torch.from_numpy(a).to(dev) for a in _digits(batch, L, L))
        for g, w in zip(kernels.select_small(tabs, absd, sgn), kernels.select_plain(tabs, absd, sgn)):
            assert torch.equal(g, w)
    assert {k: kernels.counts()[k] for k in ("endo", "pneg", "normalize3", "select_small")} == {
        "endo": 8, "pneg": 4, "normalize3": 4, "select_small": 3}
