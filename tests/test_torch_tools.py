"""The measurement path's plain versions on the CPU against the JAX
package's tools: ``sr_variant`` and ``grid_copy`` against the kernel bodies
of ``tools/r5_experiments.py`` run through ``pl.pallas_call(...,
interpret=True)`` with the tool's grid and index maps; the chain phases
against the bodies of ``tools/phase_bench.py`` applied in jnp (mod p for
the value phases, exact integers for the limb-form ones); the tabled MSM
against ``msm`` and the host answer; and the bench and tools refusing to
run without CUDA.  ``tools/`` is no package, so its modules are loaded
from their files."""

import importlib
import importlib.util
import pathlib
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from bulletproofspp_tpu.core.fields import Q, R  # noqa: E402
from bulletproofspp_tpu.ops import curve as jcurve  # noqa: E402
from bulletproofspp_tpu.ops import msm as jmsm  # noqa: E402
from bulletproofspp_tpu.ops import pallas_field as pf  # noqa: E402
from bulletproofspp_tpu_torch import bench, bounds, native  # noqa: E402
from bulletproofspp_tpu_torch.core import ec  # noqa: E402
from bulletproofspp_tpu_torch.ops import curve, kernels, limb, msm  # noqa: E402

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
L = 2048
ROWS = 2


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def r5():
    return _tool("r5_experiments")


@pytest.fixture(scope="module")
def phases():
    return _tool("phase_bench")


@pytest.fixture(scope="module")
def inputs():
    """Flat tables of L lanes (multiples of G, random projective scaling,
    identity lanes) and digits (ROWS, L), as port planes and numpy."""
    rng = np.random.default_rng(70)
    cols = ([], [], [])
    for i in range(L):
        if i % 7 == 3:
            coords = (0, int(rng.integers(1, 2**62)), 0)
        else:
            pt = ec.scalar_mul(int(rng.integers(1, 2**62)), ec.G)
            z = (int(rng.integers(1, 2**62)) << 180) % Q
            coords = (pt[0] * z % Q, pt[1] * z % Q, z)
        for c, v in zip(cols, coords):
            c.append(v)
    tables = kernels.table_flat_plain(tuple(limb.from_ints(c, "cpu") for c in cols))
    absd = rng.integers(0, 9, size=(ROWS, L)).astype(np.uint8)
    sgn = rng.integers(0, 2, size=(ROWS, L)).astype(np.uint8)
    return tables, torch.as_tensor(absd), torch.as_tensor(sgn)


def _sr_pallas(r5, tables, absd, sgn, blk, out_w, noselect):
    """r5_experiments.sr_variant (:114-137) with memory_space=pl.ANY and
    interpret=True."""
    nblk = L // blk
    ms = pl.ANY
    tspec9 = pl.BlockSpec((144, blk), lambda i, r: (0, i), memory_space=ms)
    tspec18 = pl.BlockSpec((288, blk), lambda i, r: (0, i), memory_space=ms)
    dspec = pl.BlockSpec((1, blk), lambda i, r: (0, r * nblk + i), memory_space=ms)
    ospec = pl.BlockSpec((16, out_w), lambda i, r: (0, r * nblk + i), memory_space=ms)
    kspec = pl.BlockSpec((16, 1), lambda i, r: (0, 0), memory_space=ms)
    out = jax.ShapeDtypeStruct((16, ROWS * L * out_w // blk), jnp.uint32)
    kern = r5._sr_kernel_noselect if noselect else r5._sr_kernel
    return pl.pallas_call(
        kern, grid=(nblk, ROWS), in_specs=[kspec, dspec, dspec, tspec9, tspec18, tspec9],
        out_specs=(ospec, ospec, ospec), out_shape=(out, out, out), interpret=True,
    )(jnp.asarray(pf._kc()), jnp.asarray(absd.numpy().astype(np.uint32).reshape(1, -1)),
      jnp.asarray(sgn.numpy().astype(np.uint32).reshape(1, -1)),
      *(jnp.asarray(limb.planes_to_numpy(t)) for t in tables))


def _ints_mod_q(planes):
    return [v % Q for v in limb.unpack_ints(np.asarray(planes, np.uint32))]


@pytest.mark.parametrize("blk,out_w,noselect", [(1024, 128, False), (2048, 256, False),
                                                (512, 128, False), (1024, 128, True)])
def test_sr_variant_plain_matches_the_tool_kernel(r5, inputs, blk, out_w, noselect):
    tables, absd, sgn = inputs
    got = kernels.sr_variant(tables, absd, sgn, blk, out_w, noselect)  # a CPU tensor: the plain version
    want = _sr_pallas(r5, tables, absd, sgn, blk, out_w, noselect)
    assert got[0].shape == (16, ROWS * L * out_w // blk)
    for g, w in zip(got, want):  # projective coordinates, equal mod p lane by lane
        assert _ints_mod_q(limb.planes_to_numpy(g)) == _ints_mod_q(w)


def test_sr_variant_at_1024_128_is_select_reduce(inputs):
    tables, absd, sgn = inputs
    got = kernels.sr_variant_plain(tables, absd, sgn, 1024, 128)
    want = kernels.select_reduce_plain(tables, absd[None], sgn[None])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_grid_copy_plain_matches_the_tool_kernel(r5):
    x = np.random.default_rng(71).integers(0, 1 << 32, size=(16, L), dtype=np.uint64)
    x[:, :3] = 0xFFFFFFFF
    blk, rows = 1024, 33
    nblk = L // blk
    spec = pl.BlockSpec((16, blk), lambda i, r: (0, i), memory_space=pl.ANY)
    ospec = pl.BlockSpec((16, blk), lambda i, r: (0, r * nblk + i), memory_space=pl.ANY)
    want = pl.pallas_call(
        r5._copy_kernel, grid=(nblk, rows), in_specs=[spec], out_specs=ospec,
        out_shape=jax.ShapeDtypeStruct((16, rows * L), jnp.uint32), interpret=True,
    )(jnp.asarray(x.astype(np.uint32)))
    got = kernels.grid_copy(torch.as_tensor(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


VALUE_BODIES = {"padd": "body_padd", "mul_f16": "body_mul", "mul_small": "body_mul_small",
                "add": "body_add", "add_s17": "body_add_s17", "sub": "body_sub",
                "sub_raw2": "body_sub_raw2"}


def _chain_inputs(nstate, seed):
    rng = np.random.default_rng(seed)
    planes = [rng.integers(0, 1 << 16, size=(16, 256)) for _ in range(nstate + 3)]
    for p in planes:
        p[:, :4] = 0xFFFF  # saturated lanes
    return planes[:nstate], planes[nstate:]


@pytest.mark.parametrize("phase", sorted(VALUE_BODIES))
def test_chain_value_phases_match_phase_bench_bodies_mod_p(phases, phase):
    _, nstate, value = kernels.CHAIN_PHASES[phase]
    assert value
    a, b = _chain_inputs(nstate, 72)
    body = getattr(phases, VALUE_BODIES[phase])
    k2 = jnp.asarray(pf._kc())
    x = tuple(jnp.asarray(t.astype(np.uint32)) for t in a)
    bj = tuple(jnp.asarray(t.astype(np.uint32)) for t in b)
    pa, pb = [torch.as_tensor(t) for t in a], [torch.as_tensor(t) for t in b]
    for step in range(1, 9):
        x = body(k2, x, bj)
        if step in (1, 8):
            got = kernels.chain_plain(phase, pa, pb, step)
            assert _ints_mod_q(limb.planes_to_numpy(got)) == _ints_mod_q(x[0]), step


def _unfolded(a, b):
    t = a * b
    lo, hi = t % (1 << 256), t >> 256
    return (lo + 977 * hi + (hi << 32)) % (1 << 256)


LIMB_FORM = {"mul_w16": _unfolded,
             "carry_full": lambda x, b: (2 * x + b) % Q,
             "prod_form": lambda x, b: x * b % (1 << 256)}


@pytest.mark.parametrize("phase", sorted(LIMB_FORM))
def test_chain_limb_form_phases_match_their_integer_definition(phase):
    _, nstate, value = kernels.CHAIN_PHASES[phase]
    assert not value and nstate == 1
    a, b = _chain_inputs(1, 73)
    xs, bs = limb.unpack_ints(a[0]), limb.unpack_ints(b[0])
    for rep in (1, 8):
        want = xs
        for _ in range(rep):
            want = [LIMB_FORM[phase](x, c) for x, c in zip(want, bs)]
        got = kernels.chain_plain(phase, [torch.as_tensor(a[0])], [torch.as_tensor(t) for t in b], rep)
        assert limb.unpack_ints(got) == want, rep


@pytest.mark.parametrize("n_points", [512, 1024])
def test_msm_tabled_equals_msm_and_the_host_answer(n_points):
    px, py, pz = bench.basis(n_points, "cpu")
    scalars = [random.Random(80 + i).randrange(R) for i in range(n_points)]
    absd, sgn = bench.digits(scalars, "cpu")
    tables = msm.precompute_flat_table(px, py, pz)
    kernels.reset_counts()
    got = curve.to_affine_host(msm.msm_tabled(tables, absd, sgn))
    assert sum(kernels.counts().values()) == 0  # CPU tensors: plain versions only
    want = ec.scalar_mul(sum(s << i for i, s in enumerate(scalars)) % R, ec.G)
    assert got == curve.to_affine_host(msm.msm(px[:, None], py[:, None], pz[:, None], absd, sgn))
    assert got == [want]


def test_tabled_supported_matches_the_jax_condition(monkeypatch):
    monkeypatch.setattr(jcurve, "_pallas_enabled", lambda: True)
    for lanes in (0, 512, 1000, 1024, 1536, 2048, 3072, 4096, 1 << 20, (1 << 21) - 1024,
                  1 << 21, 1 << 22):
        assert msm.tabled_supported(lanes) == jmsm.tabled_supported(lanes), lanes
    with pytest.raises(ValueError, match="outside the tabled route"):
        msm.msm_tabled(None, torch.zeros((1, 33, 512), dtype=torch.uint8), None)


def test_bench_work_counts():
    """The bound's counts: a complete add's multiplies, distinct selected
    entries, and the MSM's adds (33 a lane tabled, 40 untabled) and
    negations."""
    assert bounds.PT_ADD == 12 * 146 + 3 * 18 + 12 * 2 + 5 * 2
    absd = torch.tensor([[[0, 1], [0, 2], [3, 2]]], dtype=torch.uint8)
    sgn = torch.tensor([[[0, 0], [1, 0], [0, 1]]], dtype=torch.uint8)
    # lane 0: |d| {0, 3}, y {0, 9, 3}; lane 1: |d| {1, 2}, y {1, 2, 11}
    assert bounds._selected_bytes(absd, sgn) == (2 * 4 + 6) * 128
    a, s = bench.digits([random.Random(9).randrange(R) for _ in range(512)], "cpu")
    tab_ops = bench._msm_work(a, s, True, 1024)[0]
    untab_ops = bench._msm_work(a, s, False, 1024)[0]
    assert untab_ops - tab_ops == bounds.table_flat(1024)[0]
    adds = 33 * (1024 - 1)  # every lane of a row summed into one, rows by Horner
    negations = int(s.sum()) * bounds.FE_SUB  # select_reduce makes -Y of negative digits
    assert tab_ops == adds * bounds.PT_ADD + 33 * (4 * bounds.PT_DBL + bounds.PT_ADD) + negations
    ms, by = bounds.bound((0, 3.35e9), 1980)
    assert by == "bytes" and abs(ms - 1.0) < 1e-12


def test_bench_line_leads_with_the_reference_headline_keys():
    """The line carries the keys the reference's bench prints (``bench.py:
    827-838``): value = tabled points/s, unit, vs_baseline = the tabled
    bound share, vs_host_engine = tabled points/s over the host engine's;
    the rest of the bench's object follows on the same line."""
    import json

    out = {"metric": "msm_32768pt_throughput", "card": "NVIDIA H100 80GB HBM3",
           "points_per_s_tabled": 25208635.5, "points_per_s_untabled": 21443000.0,
           "bound_share_tabled": 0.1602, "bound_share_untabled": 0.1589, "correct": True,
           "host_engine_points_per_s": 2500.0, "vs_host_engine": 10083.4542}
    text = bench.line(out)
    assert "\n" not in text
    got = json.loads(text)
    assert list(got)[:5] == ["metric", "value", "unit", "vs_baseline", "vs_host_engine"]
    assert (got["metric"], got["value"], got["unit"], got["vs_baseline"], got["vs_host_engine"]) == (
        "msm_32768pt_throughput", 25208635.5, "points/s", 0.1602, 10083.4542)
    assert {k: got[k] for k in out} == out


def test_host_engine_basis_is_the_references():
    """vs_host_engine's host MSM runs over the reference's points: the first
    min(64, n) doublings of G (the JAX package's ``ec.dbl``), with the
    scalars of set 0 (Random(2024))."""
    from bulletproofspp_tpu.core import ec as jec

    pts, p = [], jec.G
    for _ in range(bench.HOST_POINTS):
        pts.append(p)
        p = jec.dbl(p)
    assert bench.doublings(bench.HOST_POINTS) == pts
    rng = random.Random(2024)
    assert bench.scalar_sets(bench.HOST_POINTS, 1)[0] == [rng.randrange(R) for _ in range(64)]


def test_bound_of_launches_in_sequence_sums_their_bounds():
    """chain's ten launches: one operations-bound, nine bytes-bound; the sum
    of the ten bounds, not the bound of the summed work."""
    works = [bounds.chain(phase, 65536, 8) for phase in kernels.CHAIN_PHASES]
    each = [bounds.bound(w, 1980) for w in works]
    assert sorted(by for _, by in each) == ["bytes"] * 9 + ["operations"]
    ms, by = bounds.bound_sum(works, 1980)
    assert abs(ms - sum(t for t, _ in each)) < 1e-12
    summed = bounds.bound((sum(w[0] for w in works), sum(w[1] for w in works)), 1980)[0]
    assert ms > summed
    assert by == max(("bytes", "operations"),
                     key=lambda b: sum(t for t, x in each if x == b))
    assert bounds.bound_sum([(0, 3.35e9)], 1980) == bounds.bound((0, 3.35e9), 1980)


@pytest.mark.parametrize("kernel,chain", [
    # all rows' trees at once (7 additions), then 33 rows of 4 doublings + 1
    # addition on one warp, 2 rounds an operation
    ("tail_horner", (7 + 33 * 5, 7 * 12 + 33 * 5 * 2)),
    # 33 rows of 4 doublings + 1 addition on one warp, 2 rounds an operation
    # (on one thread: 33 * (4 * 8 + 12) = 1,452 products)
    ("horner", (165, 330)),
    # 33 rows of 4 doublings + 2 additions on one warp, 2 rounds an operation
    # (on one thread: 33 * (4 * 8 + 2 * 12) = 1,848 products)
    ("fold", (33 * 6, 33 * 6 * 2)),
    # the build's 7 additions, then 3 passes of 11 rows, 7 additions each,
    # 12 products an addition on one thread
    ("select_reduce_fused", (7 + 3 * 7, (7 + 3 * 7) * 12)),
])
def test_dependent_chain_lengths(kernel, chain):
    """Longest dependent chains at 33 rows, in point operations and in field
    product rounds (an addition is 12 products, a doubling 8)."""
    assert getattr(bounds, f"{kernel}_chain")(33) == chain
    if kernel == "tail_horner":
        # one block running the 33 row trees in turn, then Horner on one
        # thread, was 231 + 165 point operations
        assert 33 * 7 + bounds.horner_chain(33)[0] == 231 + 165 > chain[0]
    if kernel == "select_reduce_fused":  # a pass for every 11 rows begun
        assert [bounds.select_reduce_fused_chain(r)[0] for r in (1, 11, 12, 22, 23)] == \
            [14, 14, 21, 21, 28]


@pytest.mark.parametrize("name,design,chain", [
    # 7 additions of 12 products one after another on one thread, or of 2
    # rounds of 6 products on a group
    ("table_flat", "wide", (7, 84)),
    ("table_flat", "narrow", (7, 14)),
    ("padd", "wide", (1, 12)),
    ("padd", "narrow", (1, 2)),
])
def test_table_flat_and_padd_chains_by_design(name, design, chain):
    """The chain of a lane: the wide design's one thread, or the narrow
    design's group of threads."""
    assert getattr(bounds, f"{name}_chain")(design) == chain


def test_ptxas_usage_parses_the_verbose_log():
    from bulletproofspp_tpu_torch.tools import ptxas_usage

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPl' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPl
    192 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 130 registers, used 1 barriers, 6144 bytes smem, 400 bytes cmem[0]
ptxas info    : Function properties for _ZN4bppp6pt_addERKNS_2PtES2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Used 27 registers, 384 bytes cmem[0]
"""
    assert ptxas_usage.parse(log) == {
        "_Z6kernelPl": {"stack": 192, "spill_stores": 8, "spill_loads": 4, "registers": 130,
                        "smem": 6144},
        "_ZN4bppp6pt_addERKNS_2PtES2_": {"stack": 0, "spill_stores": 0, "spill_loads": 0},
        "_Z5otherv": {"registers": 27, "smem": 0},
    }


@pytest.mark.parametrize("module", ["bench", "tools.r5_experiments", "tools.phase_bench",
                                    "tools.padd_timing", "tools.assemble_host"])
def test_bench_and_tools_refuse_to_run_without_cuda(monkeypatch, capsys, module):
    mod = importlib.import_module(f"bulletproofspp_tpu_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_bench_scalar_sets_are_fresh_scalars():
    """Every scalar of a set is its own draw (equal scalars would give every
    row one digit across the lanes, and coalesced gathers)."""
    sets = bench.scalar_sets(256, 3)
    assert all(len(set(s)) == 256 and all(0 <= v < R for v in s) for s in sets)
    assert len({v for s in sets for v in s}) == 3 * 256
    assert sets == bench.scalar_sets(256, 3)  # seeded


def test_bench_scalar_digits_match_native_recode():
    scalars = [random.Random(10 + i).randrange(R) for i in range(16)]
    absd, sgn = bench.digits(scalars, "cpu")
    na, ns = native.glv_recode_batch(scalars)
    assert absd.shape == (1, 33, 32) and absd.dtype == sgn.dtype == torch.uint8
    assert np.array_equal(absd[0].numpy(), na) and np.array_equal(sgn[0].numpy(), ns)

