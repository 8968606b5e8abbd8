"""The batched fold of the lockstep prover and the square completion on the
CPU: ``msm.fold_mul_many``, ``msm.complete_square_many`` and
``kernels.complete_square`` (the plain versions of the fold_many and
complete_square kernels, B provers' lanes end to end) against the JAX
package's ``complete_square_kernel`` after ``curve.endo`` and its vmapped
kernels (``jax.vmap(fold_mul_kernel)`` and ``jax.vmap(_csq_with_endo)``,
``bulletproofspp_tpu/ops/msm.py:297`` and ``:306``) on the same numpy-seeded
planes and digits, limb for limb after normalization (tolerance 0: they are
integers); ``kernels.fold_many`` on the two bases' points against the route
it replaced (``table_flat_plain`` of each basis, then ``fold_plain`` per
prover) word for word; the wrappers' checks, their launches split by
FOLD_MAX_PROVERS with the group width by lanes, and their bounds."""

import ctypes

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bulletproofspp_tpu.core import ec  # noqa: E402
from bulletproofspp_tpu.core.fields import R  # noqa: E402
from bulletproofspp_tpu.ops import curve as jcurve  # noqa: E402
from bulletproofspp_tpu.ops import limb as jlimb  # noqa: E402
from bulletproofspp_tpu.ops import msm as jmsm  # noqa: E402
from bulletproofspp_tpu_torch import bounds  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, glv, kernels, limb, msm  # noqa: E402

B, L = 3, 16


def _planes(pts):
    cols = [[], [], []]
    for p in pts:
        for c, v in zip(cols, (0, 1, 0) if p is None else (p[0], p[1], 1)):
            c.append(v)
    return np.stack([jlimb.pack_ints(c) for c in cols])


def _lanes(rng, count=B):
    """(count, 3, 16, L) uint32 planes: random multiples of G, a few
    identities."""
    out = []
    for _ in range(count):
        pts = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=L)]
        pts[int(rng.integers(0, L))] = None
        out.append(_planes(pts))
    return np.stack(out)


def _digits(rng, split=False, count=B):
    """(count, 4, 33): each prover's own scalars; prover 1's E stream (or
    the only prover's) has zero digits with sign 1 (they select (0 : -1 :
    0))."""
    rows = []
    for _ in range(count):
        if split:
            k1, k2 = glv.split(int(rng.integers(1, 2**62)) ** 4 % R)
        else:
            k1 = -int(rng.integers(1, 2**62)) << 64
            k2 = int(rng.integers(1, 2**62)) << 60
        rows.append(np.stack([*glv.recode_signed(k1), *glv.recode_signed(k2)]))
    d = np.stack(rows).astype(np.uint32)
    d[min(1, count - 1), 0, :3], d[min(1, count - 1), 1, :3] = 0, 1
    assert len({d[b].tobytes() for b in range(count)}) == count
    return d


def _stacked_port(arr):
    """(B, 3, 16, L) numpy planes -> port (16, B L) planes, prover b at b L."""
    return tuple(limb.planes_from_numpy(np.concatenate(list(arr[:, c]), -1), "cpu")
                 for c in range(3))


def _canon_port(p):
    return limb.planes_to_numpy(curve.normalize3(*p))


def _canon_jax(p):
    """(B, 16, L) vmapped outputs -> (3, 16, B L) normalized planes."""
    return np.stack([np.asarray(jlimb.normalize(jnp.moveaxis(c, 0, 1))).reshape(16, -1) for c in p])


def test_fold_mul_many_matches_the_vmapped_jax_kernel():
    rng = np.random.default_rng(90)
    e, o, d = _lanes(rng), _lanes(rng), _digits(rng)
    got = msm.fold_mul_many(_stacked_port(e), _stacked_port(o), d)
    want = jmsm._fold_many_compiled(*(jnp.asarray(e[:, c]) for c in range(3)),
                                    *(jnp.asarray(o[:, c]) for c in range(3)),
                                    *(jnp.asarray(d[:, q]) for q in range(4)))
    assert np.array_equal(_canon_port(got), _canon_jax(want))
    for b in range(B):  # and per prover, the single fold on its lanes
        one = msm.fold_mul(_stacked_port(e[b:b + 1]), _stacked_port(o[b:b + 1]), *d[b])
        assert np.array_equal(_canon_port(one), _canon_port(got)[:, :, b * L:(b + 1) * L])


@pytest.fixture(scope="module")
def csq_many():
    """B provers' g0, g1 and digits, and the vmapped ``_csq_with_endo``'s
    normalized (gx, hy) on them (one compile for the tests below)."""
    rng = np.random.default_rng(91)
    g0, g1, d = _lanes(rng), _lanes(rng), _digits(rng, split=True)
    want = jmsm._csq_many_compiled(*(jnp.asarray(g0[:, c]) for c in range(3)),
                                   *(jnp.asarray(g1[:, c]) for c in range(3)),
                                   *(jnp.asarray(d[:, q]) for q in range(4)))
    return _stacked_port(g0), _stacked_port(g1), d, (_canon_jax(want[:3]), _canon_jax(want[3:]))


def test_complete_square_many_matches_the_vmapped_jax_kernel(csq_many):
    g0, g1, d, (want_gx, want_hy) = csq_many
    gx, hy = msm.complete_square_many(g0, g1, d)
    assert np.array_equal(_canon_port(gx), want_gx)
    assert np.array_equal(_canon_port(hy), want_hy)


def test_complete_square_wrapper_matches_the_vmapped_jax_kernel(csq_many):
    """``kernels.complete_square`` on the CPU (its plain version: endo, the
    batched fold, pneg and two additions) at B = 3 provers of 16 lanes,
    exact after normalization; no launch is counted."""
    g0, g1, d, (want_gx, want_hy) = csq_many
    kernels.reset_counts()
    gx, hy = kernels.complete_square(g0, g1, d)
    assert not any(kernels.counts().values())
    assert np.array_equal(_canon_port(gx), want_gx)
    assert np.array_equal(_canon_port(hy), want_hy)
    rp = kernels.fold_many_plain(g0, kernels.endo_plain(g0), d)
    want = (kernels.padd_plain(g1, rp), kernels.padd_plain(g1, kernels.pneg_plain(rp)))
    assert all(torch.equal(a, b) for a, b in zip((*gx, *hy), (*want[0], *want[1])))


def test_complete_square_wrapper_at_one_prover_matches_the_jax_kernel_after_endo():
    """B = 1, L = 16, an identity lane in g0 and in g1: the JAX package's
    ``complete_square_kernel`` after ``curve.endo`` (the single prover's
    route, ``ops/engine.py:425-426``), exact after normalization."""
    rng = np.random.default_rng(96)
    g0, g1, d = _lanes(rng, 1), _lanes(rng, 1), _digits(rng, split=True, count=1)
    ident = _planes([None])[..., 0]
    g0[0, :, :, 3], g1[0, :, :, 5] = ident, ident
    gx, hy = kernels.complete_square(_stacked_port(g0), _stacked_port(g1), d)
    j0 = tuple(jnp.asarray(g0[0, c]) for c in range(3))
    want = jmsm._csq_compiled(*j0, *jcurve.endo(j0), *(jnp.asarray(g1[0, c]) for c in range(3)),
                              *(jnp.asarray(d[0, q]) for q in range(4)))
    assert np.array_equal(_canon_port(gx), _canon_jax(tuple(c[None] for c in want[:3])))
    assert np.array_equal(_canon_port(hy), _canon_jax(tuple(c[None] for c in want[3:])))


def test_complete_square_wrapper_checks_its_arguments(monkeypatch):
    """Digits of (B, 4, ROWS) whose B divides the lanes, in range (on the
    CPU too); on a CUDA tensor (stubbed) g0 and g1 of one (16, B L) shape;
    20 provers take two launches of 16 and 4 over the same planes, each
    with its provers' digits by value and fold_many's group width."""
    rng = np.random.default_rng(97)
    g0, g1 = _stacked_port(_lanes(rng)), _stacked_port(_lanes(rng))
    d = _digits(rng)
    with pytest.raises(ValueError, match="complete_square: digits must be"):
        kernels.complete_square(g0, g1, d[0])
    with pytest.raises(ValueError, match="complete_square: digits must be"):
        kernels.complete_square(g0, g1, np.concatenate([d, d[:2]]))
    bad = d.copy()
    bad[1, 3, 7] = 2
    with pytest.raises(ValueError, match="fold digits"):
        kernels.complete_square(g0, g1, bad)
    seen = []

    def launch(name, shape, dev, *args):
        packed = ctypes.string_at(args[6], kernels.FOLD_MAX_PROVERS * 132)
        seen.append((name, shape, args[-5:], packed))

    monkeypatch.setattr(kernels, "_launch", launch)
    monkeypatch.setattr(kernels, "_check", lambda *planes: torch.device("cuda", 0))
    monkeypatch.setattr(kernels, "_empty", lambda shape, like: tuple(
        torch.zeros(shape, dtype=torch.int64, device="meta") for _ in range(3)))
    n = 20 * L
    meta = [torch.zeros((16, n), dtype=torch.int64, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="complete_square takes its points"):
        kernels.complete_square(meta, [t[:, :-16] for t in meta], np.stack([d[0]] * 20))
    many = np.stack([d[b % B] for b in range(20)])
    gx, hy = kernels.complete_square(meta, meta, many)
    g16, g4 = kernels.fold_many_group(16 * L), kernels.fold_many_group(4 * L)
    assert [(s[0], s[1], s[2]) for s in seen] == [
        ("complete_square", f"B=16 L={L} G={g16}", (n, L, 0, 16, g16)),
        ("complete_square", f"B=4 L={L} G={g4}", (n, L, 16 * L, 4, g4))]
    assert seen[0][3] == b"".join(kernels.fold_digits(x) for x in many[:16])
    assert seen[1][3] == b"".join(kernels.fold_digits(x) for x in many[16:]) + bytes(12 * 132)
    assert len(gx) == len(hy) == 3 and gx[0] is not hy[0]


def test_fold_many_wrapper_on_cpu_takes_the_plain_version_and_checks_digits():
    rng = np.random.default_rng(92)
    pe, po = _stacked_port(_lanes(rng)), _stacked_port(_lanes(rng))
    d = _digits(rng)
    kernels.reset_counts()
    got = kernels.fold_many(pe, po, d)
    assert kernels.counts()["fold_many"] == 0
    assert torch.equal(curve.normalize3(*got), curve.normalize3(*kernels.fold_many_plain(pe, po, d)))
    with pytest.raises(ValueError, match="fold_many: digits must be"):
        kernels.fold_many(pe, po, d[0])  # one prover's (4, 33): not (B, 4, 33)
    with pytest.raises(ValueError, match="fold_many: digits must be"):
        kernels.fold_many(pe, po, np.concatenate([d, d[:2]]))  # 5 provers of 48 lanes
    bad = d.copy()
    bad[2, 0, 5] = 9
    with pytest.raises(ValueError, match="fold digits"):
        kernels.fold_many(pe, po, bad)
    with pytest.raises(ValueError, match="group 4"):
        kernels.fold_many_design(pe, po, d, 4)


def test_fold_many_splits_into_launches_of_at_most_16_provers(monkeypatch):
    """On a CUDA tensor (stubbed here) 20 provers take two launches, of 16
    and 4, over lanes [0, 16 L) and [16 L, 20 L) of the same point planes,
    each with its provers' digits packed by value and the group width its
    lanes pick (``fold_many_group``), or the one forced."""
    seen = []

    def launch(name, shape, dev, *args):
        packed = ctypes.string_at(args[6], kernels.FOLD_MAX_PROVERS * 132)
        seen.append((name, shape, args[-5:], packed))

    monkeypatch.setattr(kernels, "_launch", launch)
    monkeypatch.setattr(kernels, "_check", lambda *planes: torch.device("cuda", 0))
    monkeypatch.setattr(kernels, "_empty", lambda shape, like: tuple(
        torch.zeros(shape, dtype=torch.int64, device="meta") for _ in range(3)))
    n = 20 * L
    meta = [torch.zeros((16, n), dtype=torch.int64, device="meta") for _ in range(3)]
    rng = np.random.default_rng(93)
    d = np.stack([_digits(rng)[b % B] for b in range(20)])
    g16, g4 = kernels.fold_many_group(16 * L), kernels.fold_many_group(4 * L)
    kernels.fold_many(meta, meta, d)
    assert [(s[0], s[1], s[2]) for s in seen] == [
        ("fold_many", f"B=16 L={L} G={g16}", (n, L, 0, 16, g16)),
        ("fold_many", f"B=4 L={L} G={g4}", (n, L, 16 * L, 4, g4))]
    assert seen[0][3] == b"".join(kernels.fold_digits(x) for x in d[:16])
    assert seen[1][3] == b"".join(kernels.fold_digits(x) for x in d[16:]) + bytes(12 * 132)
    seen.clear()
    kernels.fold_many_design(meta, meta, d, 16)
    assert [s[1] for s in seen] == [f"B=16 L={L} G=16", f"B=4 L={L} G=16"]


@pytest.mark.parametrize("lanes", [32, 256, 1024, 2048, 8192])
def test_fold_many_group_is_8_from_the_wide_lanes_and_16_below(lanes):
    """The smoke's launches: two lanes a warp under FOLD_MANY_WIDE_LANES,
    four from there."""
    want = 8 if lanes >= kernels.FOLD_MANY_WIDE_LANES else 16
    assert kernels.fold_many_group(lanes) == want in kernels.FOLD_MANY_GROUPS


def test_fold_many_bound_is_the_sum_of_the_provers_folds():
    """The provers' folds' multiplies and the two tables' the launch builds;
    its bytes are the two bases' points in and the result out (the tables
    and the digits, sent in the launch, never cross device memory)."""
    rng = np.random.default_rng(94)
    d = _digits(rng)
    ops, nbytes = bounds.fold_many(B * L, d)
    parts = [bounds.fold(L, x) for x in d]
    tables = 2 * bounds.table_flat(B * L)[0]
    assert ops == sum(p[0] for p in parts) + tables
    assert nbytes == B * L * 3 * bounds.PT_BYTES
    assert ops == B * bounds.fold(L, d[0])[0] + tables  # the multiplies do not depend on the digits


@pytest.mark.parametrize("group,chain", [(8, (14 + 198, 424)), (16, (7 + 198, 410)),
                                         (32, (7 + 198, 410))])
def test_fold_many_chain_counts_the_tables_by_group(group, chain):
    """At 16 and 32 threads a lane the two tables are built at once."""
    assert bounds.fold_many_chain(33, group) == chain


def test_complete_square_bound_adds_phi_and_the_two_additions_to_fold_many():
    """fold_many's multiplies plus, a lane, phi's product, the negation and
    the two additions; g0 and g1 in, g1 + r g0 and g1 - r g0 out."""
    rng = np.random.default_rng(98)
    d = _digits(rng, split=True)
    ops, nbytes = bounds.complete_square(B * L, d)
    lane = bounds.FE_MUL + bounds.FE_SUB + 2 * bounds.PT_ADD
    assert ops == bounds.fold_many(B * L, d)[0] + B * L * lane
    assert nbytes == B * L * 4 * bounds.PT_BYTES


@pytest.mark.parametrize("group,chain", [(8, (14 + 198 + 2, 429)), (16, (7 + 198 + 1, 413))])
def test_complete_square_chain_adds_phi_and_the_additions_by_group(group, chain):
    """At 16 threads a lane the two additions run at once, one a half."""
    assert bounds.complete_square_chain(33, group) == chain


def _edge_digits(rng, count):
    """``_digits`` with rows of digit 0 with sign 1, +8 and -8 in every
    prover's two streams."""
    d = _digits(rng, count=count)
    d[:, 0, :2], d[:, 1, :2] = 0, 1
    d[:, 0, 7], d[:, 1, 7], d[:, 2, 9], d[:, 3, 9] = 8, 0, 8, 1
    d[:, 2, 20], d[:, 3, 20], d[:, 0, 31], d[:, 1, 31] = 8, 0, 8, 1
    return d


COUNTS = (1, 2, 16)


@pytest.fixture(scope="module")
def replaced_and_jax():
    """For each count of COUNTS, its provers' lanes (an identity at lane 0
    of each, and more), digits (``_edge_digits``), the route fold_many
    replaced (``table_flat_plain`` of each basis, then ``fold_plain`` per
    prover: (16, count L) planes) and the vmapped ``fold_mul_kernel``'s
    normalized planes.  One JAX call over all sum(COUNTS) provers (each
    prover's fold is its own: one compile, not three)."""
    rng = np.random.default_rng(95)
    total = sum(COUNTS)
    e, o = _lanes(rng, total), _lanes(rng, total)
    ident = _planes([None])[..., 0]
    e[:, :, :, 0], o[:, :, :, 0] = ident, ident
    d = _edge_digits(rng, total)
    want = _canon_jax(jmsm._fold_many_compiled(*(jnp.asarray(e[:, c]) for c in range(3)),
                                               *(jnp.asarray(o[:, c]) for c in range(3)),
                                               *(jnp.asarray(d[:, q]) for q in range(4))))
    out, b0 = {}, 0
    for count in COUNTS:
        pe, po = _stacked_port(e[b0:b0 + count]), _stacked_port(o[b0:b0 + count])
        te, to = kernels.table_flat_plain(pe), kernels.table_flat_plain(po)
        parts = [kernels.fold_plain(tuple(t[:, b * L:(b + 1) * L] for t in te),
                                    tuple(t[:, b * L:(b + 1) * L] for t in to), d[b0 + b])
                 for b in range(count)]
        replaced = tuple(torch.cat([p[c] for p in parts], 1) for c in range(3))
        out[count] = (pe, po, d[b0:b0 + count], replaced, want[:, :, b0 * L:(b0 + count) * L])
        b0 += count
    return out


@pytest.mark.parametrize("count", COUNTS)
def test_fold_many_on_points_equals_the_replaced_route_and_the_vmapped_jax_kernel(
        replaced_and_jax, count):
    """``kernels.fold_many`` on the CPU takes the two bases' points: word for
    word the route it replaced, and the vmapped ``fold_mul_kernel`` after
    normalization, at B = 1, 2 and 16 provers of 16 lanes, identity lanes
    and digits 0 with sign 1, +8 and -8 among them."""
    pe, po, d, replaced, want = replaced_and_jax[count]
    got = kernels.fold_many(pe, po, d)
    assert all(torch.equal(g, r) for g, r in zip(got, replaced))
    assert np.array_equal(_canon_port(got), want)


def test_fold_mul_is_fold_many_at_one_prover(replaced_and_jax, monkeypatch):
    """``msm.fold_mul`` (the one-prover fold of fold_bv, fold_bases and the
    engine) hands its two bases' points and one prover's digits to
    ``kernels.fold_many``: word for word the route it replaced (table_flat of
    each basis, then fold) and the JAX package's ``fold_mul_kernel`` after
    normalization, identity lanes and digits 0 with sign 1, +8 and -8
    among them."""
    pe, po, d, replaced, want = replaced_and_jax[1]
    seen = []
    inner = kernels.fold_many
    monkeypatch.setattr(kernels, "fold_many", lambda *a: seen.append(np.asarray(a[2]).shape)
                        or inner(*a))
    got = msm.fold_mul(pe, po, *d[0])
    assert seen == [(1, 4, glv.ROWS)]
    assert all(torch.equal(g, r) for g, r in zip(got, replaced))
    assert np.array_equal(_canon_port(got), want)


def test_fold_phi_plain_is_fold_many_of_the_points_and_their_endo(replaced_and_jax):
    """``kernels.fold_phi`` on the CPU: ``fold_many_plain(p, endo_plain(p))``
    word for word, one prover and two (the plain version splits by prover
    as the kernel's launch does); its digit checks are fold_many's."""
    for count in (1, 2):
        pe, _, d, _, _ = replaced_and_jax[count]
        kernels.reset_counts()
        got = kernels.fold_phi(pe, d)
        assert not any(kernels.counts().values())
        want = kernels.fold_many_plain(pe, kernels.endo_plain(pe), d)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="fold_phi: digits must be"):
        kernels.fold_phi(pe, d[0])
    assert "fold" in kernels.OFF_PATH and set(kernels.OFF_PATH) <= set(kernels.KERNELS)


@pytest.mark.parametrize("group", [8, 16])
def test_fold_phi_bound_and_chain_add_phis_product(group):
    """fold_many's multiplies and phi's product a lane; one basis read, the
    result written; phi's product one round before the tables."""
    rng = np.random.default_rng(99)
    d = _digits(rng, split=True, count=1)
    ops, nbytes = bounds.fold_phi(L, d)
    assert ops == bounds.fold_many(L, d)[0] + L * bounds.FE_MUL
    assert nbytes == L * 2 * bounds.PT_BYTES
    many = bounds.fold_many_chain(33, group)
    assert bounds.fold_phi_chain(33, group) == (many[0], many[1] + 1)
