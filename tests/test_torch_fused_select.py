"""The MSM route from 128 to 1,023 lanes with its select in the first
reduction, its canonical result, and uint8 digits.

``msm.msm`` no longer stores the selected points (select_small) nor
normalizes its result in a launch of its own (normalize3): reduce_block
(256 and 512 lanes) or tail_horner (128 lanes) read their first level's
operands by digit from the flat tables, and horner's last warp stores the
result canonical.  On the CPU the wrappers run their plain versions:

  * the from-tables plain routes at L = 128, 256 and 512 and B = 1 and 2
    MSMs of 33 rows (at B = 2 the card runs the wide reduce_block: 8,448
    output lanes), digits 0 and 8 and sign 1 and identity lanes among the
    inputs, equal word for word to ``select_plain`` + the unfused plain
    route, and to host integers after affine conversion;
  * after normalization, equal to the JAX package's ``msm_kernel`` at those
    lane counts (its Pallas route, the same halving order, in interpret
    mode on the CPU as the JAX package's own tests run its kernels), and
    ``msm.msm(..., canonical=True)`` word for word to
    ``curve._normalize3(msm_kernel(...))``;
  * uint8 digits through ``msm.msm`` at every route (16 to 1,024 lanes)
    equal to the route as it ran before, on int64 digits: select_plain,
    the unfused reductions, then normalize3.

The kernels are held against select_small + the unfused kernels on the card
in ``tests/test_torch_cuda.py`` (``cuda``-marked) and ``chip_smoke.py``
phase 15.
"""

import functools

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core.fields import Q, R
from bulletproofspp_tpu_torch.ops import kernels, limb, msm
from test_torch_lane_ops import _jax  # noqa: E402

ROWS = 33
CASES = [(B, L) for L in (128, 256, 512) for B in (1, 2)]
JAX_ROWS = 2  # the JAX route's rows: tail_horner_pallas interprets a minute at 2


def _case(batch: int, L: int, seed: int, rows: int = ROWS):
    """B MSMs of L lanes: multiples of G with random Z, about every 5th lane
    the identity, in MSM 0 lane t + L/2 the point of lane t with another Z;
    (B, rows, L) uint8 digits, random with the edges: row 0 zero digits with
    sign 1, and from 3 rows on row 1 all 8 and in MSM 0 row 2 lane t + L/2
    the digit of lane t with the other sign (every route's first level adds
    lanes t and t + L/2: P + (-P)), else in MSM 0 row 1 (with some 8s).
    Returns numpy (3, 16, B, L) planes, the affine lanes and the digits."""
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
    arr = np.stack([limb.pack_ints(c).reshape(16, batch, L) for c in cols])
    absd = rng.integers(0, 9, size=(batch, rows, L))
    sgn = rng.integers(0, 2, size=(batch, rows, L))
    absd[:, 0], sgn[:, 0] = 0, 1
    cancel = 2 if rows >= 3 else 1
    if rows >= 3:
        absd[:, 1] = 8
    else:
        absd[:, 1, ::3] = 8
    absd[0, cancel, h:] = absd[0, cancel, :h]
    sgn[0, cancel, h:] = 1 - sgn[0, cancel, :h]
    return arr, lanes, absd.astype(np.uint8), sgn.astype(np.uint8)


def _port(arr):
    return tuple(limb.planes_from_numpy(a, "cpu") for a in arr)


def _host(lanes, absd, sgn, batch: int, L: int) -> list:
    """sum_l (sum_r 16^(rows-1-r) (-1)^s |d|) P_l of each MSM, host integers."""
    out = []
    for b in range(batch):
        total = None
        for j in range(L):
            p = lanes[b * L + j]
            if p is None:
                continue
            k = 0
            for d, s in zip(absd[b, :, j], sgn[b, :, j]):
                k = 16 * k + (-int(d) if s else int(d))
            total = ec.add(total, ec.scalar_mul(k % R, p))
        out.append(total)
    return out


def _affine(c) -> list:
    """A canonical (3, 16, B) tensor -> affine points / None."""
    xs, ys, zs = (limb.unpack_ints(limb.planes_to_numpy(c[i])) for i in range(3))
    return [None if z == 0 else (x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q)
            for x, y, z in zip(xs, ys, zs)]


def _unfused(tables, absd, sgn, canonical=False):
    """The route with the select on its own: select_plain, the reduce_block
    chain and tail_horner on the selected planes (plain versions)."""
    batch, rows, L = absd.shape
    flat = tuple(t.reshape(16, -1) for t in kernels.select_plain(tables, absd, sgn))
    width = L
    while width > 128:
        f = min(8, width // 128)
        flat = kernels.reduce_block_plain(flat, f)
        width //= f
    return kernels.tail_horner_plain(tuple(t.reshape(16, batch, rows * 128) for t in flat), rows,
                                     canonical)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("B,L", CASES)
def test_from_tables_routes_equal_select_plain_and_the_unfused_route(B, L):
    """The first launch from the tables (the wrapper on the CPU, and both
    reduce_block designs' entry) equals it on select_plain's planes word for
    word; so does the whole route, and its canonical form equals
    normalize3 of it; the result is the host integers' MSM."""
    arr, lanes, absd_np, sgn_np = _case(B, L, 97 * L + B)
    p = _port(arr)
    tables = kernels.table_flat_plain(tuple(t.reshape(16, -1) for t in p))
    absd, sgn = torch.from_numpy(absd_np), torch.from_numpy(sgn_np)
    sel = kernels.select_plain(tables, absd, sgn)
    if L == 128:
        got = kernels.tail_horner(tables, ROWS, absd=absd, sgn=sgn)
        assert _equal(got, kernels.tail_horner_plain(tuple(t.reshape(16, B, -1) for t in sel),
                                                     ROWS))
    else:
        f = L // 128
        assert (B * ROWS * L // f >= kernels.REDUCE_BLOCK_WIDE_LANES) == (B == 2)  # wide on the card
        want = kernels.reduce_block_plain(tuple(t.reshape(16, -1) for t in sel), f)
        for narrow in (True, False):
            assert _equal(kernels.reduce_block_design(tables, f, narrow, absd, sgn), want)
        assert _equal(kernels.reduce_block(tables, f, absd=absd, sgn=sgn), want)
    got = msm.msm(*p, absd, sgn)
    assert _equal(got, _unfused(tables, absd, sgn))
    canon = msm.msm(*p, absd, sgn, canonical=True)
    assert torch.equal(canon, kernels.normalize3_plain(*got))
    assert _affine(canon) == _host(lanes, absd_np, sgn_np, B, L)


@pytest.fixture(scope="module")
def jax_msm():
    """msm_kernel (``bulletproofspp_tpu/ops/msm.py:105``) on one MSM,
    normalized: its Pallas route from 128 lanes (the table's additions
    through padd_pallas from 256 lanes, the one-hot select, the
    reduce_block_pallas chain, tail_horner_pallas), the kernels in interpret
    mode; results cached by case."""
    jcurve, jmsm, pallas_field = (_jax(m) for m in ("ops.curve", "ops.msm", "ops.pallas_field"))
    jnp = pytest.importorskip("jax.numpy")
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcurve, "_pallas_enabled", lambda: True)
        for name in ("padd_pallas", "reduce_block_pallas", "tail_horner_pallas"):
            mp.setattr(pallas_field, name,
                       functools.partial(getattr(pallas_field, name), interpret=True))

        def run(B, L):
            if (B, L) not in cache:
                arr, _, absd, sgn = _case(B, L, 31 * L + B, JAX_ROWS)
                outs = []
                for b in range(B):
                    res = jmsm.msm_kernel(*(jnp.asarray(a[:, b]) for a in arr),
                                          jnp.asarray(absd[b].astype(np.uint32)),
                                          jnp.asarray(sgn[b].astype(np.uint32)))
                    outs.append(np.asarray(jcurve._normalize3(*res))[..., 0])
                cache[B, L] = (arr, absd, sgn, np.stack(outs, -1))
            return cache[B, L]

        yield run


@pytest.mark.parametrize("B,L", CASES)
def test_from_tables_route_equals_the_jax_msm_kernel_after_normalization(jax_msm, B, L):
    """The port's projective result (the select in its first reduction),
    normalized, against the JAX package's msm_kernel normalized: the same
    additions in the same order, so the same words."""
    arr, absd, sgn, want = jax_msm(B, L)
    got = msm.msm(*_port(arr), torch.from_numpy(absd), torch.from_numpy(sgn))
    assert np.array_equal(np.stack([limb.planes_to_numpy(limb.normalize(t)) for t in got]), want)


@pytest.mark.parametrize("B,L", CASES)
def test_canonical_msm_equals_the_jax_normalize3_of_msm_kernel(jax_msm, B, L):
    """``msm.msm(..., canonical=True)`` word for word against
    ``curve._normalize3(msm_kernel(...))``: one stacked (3, 16, B) array."""
    arr, absd, sgn, want = jax_msm(B, L)
    got = msm.msm(*_port(arr), torch.from_numpy(absd), torch.from_numpy(sgn), canonical=True)
    assert got.shape == (3, 16, B) and np.array_equal(limb.planes_to_numpy(got), want)


def _route_before(px, py, pz, absd, sgn):
    """``msm.msm`` as it ran on int64 digits before the select moved into the
    reductions: the lane tree under 128 lanes, select_small's plain version
    and the unfused chain to 1,023, select_reduce from 1,024; normalize3 of
    the result after it."""
    batch, L = px.shape[1:]
    tables = kernels.table_flat_plain(tuple(t.reshape(16, -1) for t in (px, py, pz)))
    if L < 128:
        out = kernels.horner_plain(*kernels.reduce_lanes_plain(tables, absd, sgn))
    elif L < 1024:
        out = _unfused(tables, absd, sgn)
    else:
        flat, width, rows = kernels.select_reduce_plain(tables, absd, sgn), L // 8, absd.shape[1]
        while width > 128:
            f = min(8, width // 128)
            flat = kernels.reduce_block_plain(flat, f)
            width //= f
        out = kernels.tail_horner_plain(tuple(t.reshape(16, batch, rows * 128) for t in flat), rows)
    return kernels.normalize3_plain(*out)


@pytest.mark.parametrize("L", [16, 128, 256, 512, 1024])
def test_uint8_digits_through_msm_equal_the_route_before(L):
    """Two MSMs of L lanes on uint8 digits (the engine's, now the kernels'
    type) equal word for word the int64 route as it was: projective, and
    canonical against normalize3 after it."""
    arr, _, absd, sgn = _case(2, L, 13 * L)
    p = _port(arr)
    a8, s8 = torch.from_numpy(absd), torch.from_numpy(sgn)
    assert a8.dtype == s8.dtype == torch.uint8
    want = _route_before(*p, a8.long(), s8.long())
    assert torch.equal(kernels.normalize3_plain(*msm.msm(*p, a8, s8)), want)
    assert torch.equal(msm.msm(*p, a8, s8, canonical=True), want)
    if L < 1024:
        tables = kernels.table_flat_plain(tuple(t.reshape(16, -1) for t in p))
        assert _equal(kernels.select_plain(tables, a8, s8),
                      kernels.select_plain(tables, a8.long(), s8.long()))
