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


@pytest.mark.parametrize("phase", sorted(kernels.ROUND_PHASES))
def test_chain_round_phases_are_the_complete_addition_and_doubling(phase):
    """chain's round phases on the CPU (their plain versions): x + b (the
    padd phase's steps) or 2 x (curve.pdbl), at 1 and 8 steps, on
    saturated lanes and random limbs; no launch."""
    a, b = _chain_inputs(3, 74)
    pa, pb = tuple(torch.as_tensor(t) for t in a), tuple(torch.as_tensor(t) for t in b)
    add = kernels.ROUND_PHASES[phase][1]
    kernels.reset_counts()
    for rep in (1, 8):
        got = kernels.round_chain(phase, pa, pb, rep)
        want = pa
        for _ in range(rep):
            want = kernels.padd_plain(want, pb) if add else curve.pdbl(want)
        assert torch.equal(got, want[0]), rep
    if add:
        assert torch.equal(got, kernels.chain_plain("padd", pa, pb, 8))
    assert not any(kernels.counts().values())


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
                                    "tools.padd_timing", "tools.assemble_host",
                                    "tools.kernel_turns"])
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



# --- csrc/field.cuh's representatives ------------------------------------
# Two transcriptions, word by word, in Python integers: the 64-bit carry
# code field.cuh had before its carry chains (the words every raw equality
# on the card was first taken with), and its carry chains, one PTX
# instruction a call with the carry flag beside them.  The model
# (kernels.field_words) must equal the first; the second must equal it.

M32, M64 = (1 << 32) - 1, (1 << 64) - 1
DROPPED_CARRY = 94329926858193610711403129864407773699609837703255222953893265490612872160623
FIELD_EDGE = [0, 1, Q - 1, Q, Q + 1, Q - 2, (1 << 256) - 1, (1 << 256) % Q, (1 << 256) % Q - 1,
              (1 << 32) + 976, int("FFFF" * 8 + "0000" * 8, 16), int("FFFF0000" * 8, 16),
              int("0000FFFF" * 8, 16), (1 << 128) - 1, (1 << 255), DROPPED_CARRY,
              DROPPED_CARRY * DROPPED_CARRY % Q]


def _words(v):
    return [(v >> (32 * k)) & M32 for k in range(8)]


def _value(w):
    return sum(x << (32 * k) for k, x in enumerate(w))


def _i64(v):
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def _u64_fold(r, c):
    m = (c * 977) & M64
    acc = (r[0] + (m & M32)) & M64
    r[0] = acc & M32
    acc = ((acc >> 32) + r[1] + (m >> 32) + (c & M32)) & M64
    r[1] = acc & M32
    acc = ((acc >> 32) + r[2] + (c >> 32)) & M64
    r[2] = acc & M32
    acc >>= 32
    for k in range(3, 8):
        acc = (acc + r[k]) & M64
        r[k] = acc & M32
        acc >>= 32
    o = acc & M32
    acc = (r[0] + o * 977) & M64
    r[0] = acc & M32
    acc = ((acc >> 32) + r[1] + o) & M64
    r[1] = acc & M32
    acc >>= 32
    for k in range(2, 8):
        acc = (acc + r[k]) & M64
        r[k] = acc & M32
        acc >>= 32
    return r


def _u64_sub_c(r, o):
    t = _i64(r[0] - o * 977)
    r[0] = t & M32
    t = _i64((t >> 32) + r[1] - o)
    r[1] = t & M32
    t >>= 32
    for k in range(2, 8):
        t = _i64(t + r[k])
        r[k] = t & M32
        t >>= 32
    return (-t) & M32


def _u64_field(op, a, b):
    """fe_mul / fe_add / fe_sub (and fe_mul_small by b's low word, fe_canon)
    as field.cuh wrote them with u64 and int64 carries (fe_mul_wide's
    schoolbook, fe_reduce512, fe_fold, fe_sub_c)."""
    r = [0] * 8
    if op == "add":
        acc = 0
        for k in range(8):
            acc = (acc + a[k] + b[k]) & M64
            r[k] = acc & M32
            acc >>= 32
        return _u64_fold(r, acc)
    if op == "sub":
        t = 0
        for k in range(8):
            t = _i64(t + a[k] - b[k])
            r[k] = t & M32
            t >>= 32
        _u64_sub_c(r, _u64_sub_c(r, (-t) & M32))
        return r
    if op == "mul_small":  # a * k, k = b's low word
        acc = 0
        for k in range(8):
            acc = (acc + a[k] * b[0]) & M64
            r[k] = acc & M32
            acc >>= 32
        return _u64_fold(r, acc)
    if op == "canon":
        acc = a[0] + 977
        r[0] = acc & M32
        acc = (acc >> 32) + a[1] + 1
        r[1] = acc & M32
        acc >>= 32
        for k in range(2, 8):
            acc += a[k]
            r[k] = acc & M32
            acc >>= 32
        return r if acc else list(a)
    t = [0] * 16
    for i in range(8):
        c = 0
        for j in range(8):
            c = (c + a[i] * b[j] + t[i + j]) & M64
            t[i + j] = c & M32
            c >>= 32
        t[i + 8] = c & M32
    acc = 0
    for k in range(8):
        acc = (acc + t[k] + t[8 + k] * 977 + (t[7 + k] if k else 0)) & M64
        r[k] = acc & M32
        acc >>= 32
    return _u64_fold(r, (acc + t[15]) & M64)


class _Ptx:
    """The PTX carry instructions field.cuh issues, on one carry flag."""

    def __init__(self):
        self.cf = 0

    def _set(self, v, cc):
        if cc:
            self.cf = v >> 32 if v >= 0 else 1
        return v & M32

    def add(self, a, b, carry_in=False, cc=True):
        return self._set(a + b + (self.cf if carry_in else 0), cc)

    def sub(self, a, b, borrow_in=False, cc=True):
        return self._set(a - b - (self.cf if borrow_in else 0), cc)

    def mad(self, a, b, c, hi=False, carry_in=False, cc=True):
        p = a * b
        return self._set(((p >> 32) if hi else (p & M32)) + c + (self.cf if carry_in else 0), cc)


def _ptx_fold_words(x, r, w0, w1, w2):
    r[0] = x.add(r[0], w0)
    r[1] = x.add(r[1], w1, True)
    r[2] = x.add(r[2], w2, True)
    for k in range(3, 8):
        r[k] = x.add(r[k], 0, True)
    o = x.add(0, 0, True, cc=False)
    r[0] = x.add(r[0], o * 977 & M32)
    r[1] = x.add(r[1], o, True)
    r[2] = x.add(r[2], 0, True, cc=False)


def _ptx_mul_words(x, a, b, W):
    e, o = [0] * 17, [0] * 17  # pairs from even words, pairs from odd words
    for i in range(8):
        for acc, j0 in ((e, i & 1), (o, 1 - (i & 1))):
            for n in range(4):
                j = j0 + 2 * n
                k = i + j
                if k < W:
                    acc[k] = x.mad(a[j], b[i], acc[k], carry_in=n > 0)
                if k + 1 < W:
                    acc[k + 1] = x.mad(a[j], b[i], acc[k + 1], hi=True, carry_in=True)
            if i + j0 + 8 < W:
                acc[i + j0 + 8] = x.add(acc[i + j0 + 8], 0, True, cc=False)
    t = [e[0], x.add(e[1], o[1])]
    for k in range(2, W):
        t.append(x.add(e[k], o[k], True, cc=k + 1 < W))
    return t


def _ptx_reduce_pass(x, t):
    h, r, q = t[8:], [0] * 8, [0] * 9
    for k in range(0, 8, 2):
        r[k] = x.mad(h[k], 977, t[k], carry_in=k > 0)
        r[k + 1] = x.mad(h[k], 977, t[k + 1], hi=True, carry_in=True)
    r8 = x.add(0, 0, True, cc=False)
    for k in range(1, 8, 2):
        q[k] = x.mad(h[k], 977, h[k - 1], carry_in=k > 1)
        q[k + 1] = x.mad(h[k], 977, h[k], hi=True, carry_in=True)
    q9 = x.add(0, 0, True, cc=False)
    r[1] = x.add(r[1], q[1])
    for k in range(2, 8):
        r[k] = x.add(r[k], q[k], True)
    clo = x.add(r8, q[8], True)
    return r, clo, x.add(q9, 0, True, cc=False)


def _ptx_sqr_wide(x, a):
    """fe_sqr's 512-bit square: the cross products by the parity of their
    word, their sum doubled by a funnel shift, the squares added."""
    e, o = [0] * 17, [0] * 17
    for i in range(7):
        for acc, j0 in ((e, i + 2), (o, i + 1)):
            if j0 >= 8:
                continue
            for j in range(j0, 8, 2):
                acc[i + j] = x.mad(a[j], a[i], acc[i + j], carry_in=j > j0)
                acc[i + j + 1] = x.mad(a[j], a[i], acc[i + j + 1], hi=True, carry_in=True)
            top = i + j0 + (7 - j0) // 2 * 2 + 2
            if top < 16:
                acc[top] = x.add(acc[top], 0, True, cc=False)
    c = x.add(e[1], o[1])
    t = [0, (c << 1) & M32]
    for k in range(2, 16):
        nxt = x.add(e[k], o[k], True, cc=k < 15)
        t.append(((nxt << 1) | (c >> 31)) & M32)
        c = nxt
    t[0] = x.mad(a[0], a[0], t[0])
    t[1] = x.mad(a[0], a[0], t[1], hi=True, carry_in=True)
    for i in range(1, 8):
        t[2 * i] = x.mad(a[i], a[i], t[2 * i], carry_in=True)
        t[2 * i + 1] = x.mad(a[i], a[i], t[2 * i + 1], hi=True, carry_in=True, cc=i < 7)
    return t


def _ptx_mul_split(x, a, b):
    """curve_warp.cuh's fe_mul_split: each of two threads runs fe_mul_half
    (a times b's words 4h..4h + 3, 12 words in fe_mul_words' two
    accumulators), the odd thread's words are added at word 4 of the even
    thread's (a 16-word carry chain): the 512-bit product."""
    halves = []
    for h in (0, 1):
        b4, e, o = b[4 * h:4 * h + 4], [0] * 12, [0] * 12
        for i in range(4):
            for acc, j0 in ((e, i & 1), (o, 1 - (i & 1))):
                for n in range(4):
                    j = j0 + 2 * n
                    acc[i + j] = x.mad(a[j], b4[i], acc[i + j], carry_in=n > 0)
                    acc[i + j + 1] = x.mad(a[j], b4[i], acc[i + j + 1], hi=True, carry_in=True)
                if i + j0 + 8 < 12:
                    acc[i + j0 + 8] = x.add(acc[i + j0 + 8], 0, True, cc=False)
        halves.append([e[0], x.add(e[1], o[1])]
                      + [x.add(e[k], o[k], True, cc=k + 1 < 12) for k in range(2, 12)])
    t, o = halves
    w = t[:4] + [x.add(t[4], o[0])] + [x.add(t[k], o[k - 4], True) for k in range(5, 12)]
    return w + [x.add(o[k - 4], 0, True) for k in range(12, 15)] + [x.add(o[11], 0, True, cc=False)]


def _ptx_field(op, a, b):
    """field.cuh's fe_mul, fe_add, fe_sub (and the chain tool's unfolded and
    low products), instruction by instruction."""
    x = _Ptx()
    if op == "add":
        r = [x.add(a[0], b[0])] + [x.add(a[k], b[k], True) for k in range(1, 8)]
        c = x.add(0, 0, True, cc=False)
        _ptx_fold_words(x, r, c * 977, c, 0)
        return r
    if op == "sub":
        r = [x.sub(a[0], b[0])] + [x.sub(a[k], b[k], True) for k in range(1, 8)]
        borrow = x.sub(0, 0, True, cc=False) & 1
        for step in (0, 1):
            r[0] = x.sub(r[0], borrow * 977)
            r[1] = x.sub(r[1], borrow, True, cc=step == 0)
            if step == 0:
                for k in range(2, 8):
                    r[k] = x.sub(r[k], 0, True)
                borrow = x.sub(0, 0, True, cc=False) & 1
        return r
    if op == "mul_small":
        e, o = [0] * 8, [0] * 9
        for i in range(0, 8, 2):
            pe, po = a[i] * b[0], a[i + 1] * b[0]
            e[i], e[i + 1], o[i + 1], o[i + 2] = pe & M32, pe >> 32, po & M32, po >> 32
        r = [e[0], x.add(e[1], o[1])] + [x.add(e[i], o[i], True) for i in range(2, 8)]
        c = x.add(o[8], 0, True, cc=False)
        w1 = x.add(((c * 977) >> 32) & M32, c)
        _ptx_fold_words(x, r, c * 977 & M32, w1, x.add(0, 0, True, cc=False))
        return r
    if op == "canon":
        r = [x.add(a[0], 977), x.add(a[1], 1, True)] + [x.add(a[k], 0, True) for k in range(2, 8)]
        return r if x.add(0, 0, True, cc=False) else list(a)
    if op == "prod_form":
        return _ptx_mul_words(x, a, b, 8)
    if op == "sqr_wide":
        return _ptx_sqr_wide(x, a)
    wide = {"sqr": lambda: _ptx_sqr_wide(x, a), "mul_split": lambda: _ptx_mul_split(x, a, b)}
    r, clo, chi = _ptx_reduce_pass(x, wide.get(op, lambda: _ptx_mul_words(x, a, b, 16))())
    if op == "mul_w16":
        return r
    w1 = x.add((((clo * 977) >> 32) + chi * 977) & M32, clo)
    w2 = x.add(chi, 0, True, cc=False)
    _ptx_fold_words(x, r, clo * 977 & M32, w1, w2)
    return r


def _field_pairs(seed):
    rng = random.Random(seed)
    pairs = [(u, v) for u in FIELD_EDGE for v in FIELD_EDGE]
    pairs += [(rng.getrandbits(256), rng.getrandbits(256)) for _ in range(128)]
    pairs += [(rng.getrandbits(256), v) for v in FIELD_EDGE]
    return pairs


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_words_model_the_u64_field_code(op):
    """kernels.field_words gives, limb for limb, the words field.cuh's
    64-bit carry code gave: at 0, 1, p - 1, p, p + 1, 2^256 - 1, C, the
    saturated 0xFFFF limb patterns, the round-2 dropped-carry operand and
    seeded values, every pair of edge values included."""
    pairs = _field_pairs(74)
    a = limb.from_ints([u for u, _ in pairs], "cpu")
    b = limb.from_ints([v for _, v in pairs], "cpu")
    got = limb.unpack_ints(kernels.field_words(op, a, b))
    want = [_value(_u64_field(op, _words(u), _words(v))) for u, v in pairs]
    assert got == want
    ref = {"mul": lambda u, v: u * v, "add": lambda u, v: u + v, "sub": lambda u, v: u - v}[op]
    assert all(g < 1 << 256 and (g - ref(u, v)) % Q == 0 for g, (u, v) in zip(got, pairs))


@pytest.mark.parametrize("op", ["mul", "add", "sub", "mul_w16", "prod_form", "mul_small",
                                "canon", "sqr_wide", "sqr"])
def test_field_carry_chains_give_the_models_words(op):
    """field.cuh's carry chains, transcribed instruction by instruction,
    equal the model (fe_mul, fe_add, fe_sub), the chain tool's limb-form
    phases (fe_mul_unfolded, the low words of fe_mul_words<8>), the
    64-bit carry code's words (fe_mul_small by 3, 8 and 21, fe_canon), or
    for fe_sqr the exact square (its 16 words) and then a strict value
    equal to it mod p (fe_sqr keeps no earlier representative)."""
    pairs = _field_pairs(75)
    if op == "mul_small":
        pairs = [(u, k) for u, _ in pairs[::3] for k in (3, 8, 21)]
    got = [_value(_ptx_field(op, _words(u), _words(v))) for u, v in pairs]
    if op == "sqr_wide":
        assert got == [u * u for u, _ in pairs]
        return
    if op == "sqr":
        assert all(g < 1 << 256 and (g - u * u) % Q == 0 for g, (u, _) in zip(got, pairs))
        return
    if op in ("mul_w16", "prod_form"):
        want = [LIMB_FORM[op](u, v) for u, v in pairs]
    else:
        want = [_value(_u64_field(op, _words(u), _words(v))) for u, v in pairs]
    assert got == want


@pytest.mark.parametrize("form", ["model", "carry_chains"])
def test_field_split_product_gives_fe_mul_words(form):
    """fold_rows' split product (curve_warp.cuh: fe_mul_split, each product
    on two threads, the halves added at word 4, then fe_reduce512): its word
    model (``kernels.field_words("mul_split")``) and its carry chains
    transcribed instruction by instruction give fe_mul's words, limb for
    limb: at the edge values (0, 1, p - 1, p, p + 1, 2^256 - 1, C, the
    saturated 0xFFFF limb patterns, the round-2 dropped-carry operand),
    every pair of them, and seeded values."""
    pairs = _field_pairs(76)
    want = [_value(_u64_field("mul", _words(u), _words(v))) for u, v in pairs]
    if form == "model":
        a = limb.from_ints([u for u, _ in pairs], "cpu")
        b = limb.from_ints([v for _, v in pairs], "cpu")
        got = limb.unpack_ints(kernels.field_words("mul_split", a, b))
    else:
        got = [_value(_ptx_field("mul_split", _words(u), _words(v))) for u, v in pairs]
    assert got == want


def _fold_cases():
    """(r, c) with c < 2^35 where r + c (2^32 + 977) wraps past 2^256 and
    the wrapped value's low words make adding 2^32 + 977 again carry into
    the third word, beside plain and random cases."""
    C = (1 << 32) + 977
    rng = random.Random(77)
    cases = [(0, 0), ((1 << 256) - 1, 0), ((1 << 256) - 1, 1), (0, (1 << 35) - 1),
             ((1 << 256) - 1, (1 << 35) - 1)]
    for wrapped in ((0xFFFFFFFF << 32) | 0xFFFFFFF0, (0xF << 64) | (0xFFFFFFFF << 32) | 0xFFFFFC2F,
                    (1 << 64) - 1):
        for c in (1 << 32, (1 << 33) - 1, (1 << 35) - 1, rng.getrandbits(35)):
            if c * C > wrapped:
                cases.append((wrapped + (1 << 256) - c * C, c))
    cases += [(rng.getrandbits(256), rng.getrandbits(35)) for _ in range(64)]
    return cases


def test_field_fold_words_where_the_second_wrap_carries():
    """fe_fold: the model, the 64-bit carry code and the carry chains agree
    where r + c C wraps past 2^256 and adding C once more carries out of the
    low two words (fe_mul reaches such (r, c); random operands rarely)."""
    cases = _fold_cases()
    r = limb.from_ints([v for v, _ in cases], "cpu")
    c = torch.tensor([v for _, v in cases], dtype=torch.int64)
    got = limb.unpack_ints(kernels._fold_words(r, c))
    want = [_value(_u64_fold(_words(v), k)) for v, k in cases]
    assert got == want
    chains = []
    for v, k in cases:
        x, w = _Ptx(), _words(v)
        w1 = x.add((((k & M32) * 977) >> 32) + (k >> 32) * 977, k & M32)
        _ptx_fold_words(x, w, (k & M32) * 977 & M32, w1, x.add(k >> 32, 0, True, cc=False))
        chains.append(_value(w))
    assert chains == want
    # the case the second wrap exists for is among them
    C = (1 << 32) + 977
    assert any(v + k * C >= 1 << 256 and ((v + k * C) % (1 << 64) + C) >> 64 for v, k in cases)
