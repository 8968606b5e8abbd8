"""padd, table_flat and reduce_block take their narrow design (each
addition on a group of 8 threads) below their thresholds and their wide
design (one thread per (output) lane) from there.  On the CPU: the kernel
library and the torch.cuda calls are stubbed, every wrapper runs on meta
tensors placed on cuda:0, and the entries record the arguments they were
given."""

import types

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch.ops import curve, kernels

DEV = torch.device("cuda", 0)


@pytest.fixture
def entries(monkeypatch):
    """Stubs lib(), _check and torch.cuda's device guard and stream; yields
    the list of (C entry, arguments) the wrappers launched."""
    seen = []

    class Device:
        def __init__(self, dev):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    def entry(name):
        def call(*args):
            seen.append((name, args))
            return 0
        return call

    lib = types.SimpleNamespace(**{k.entry: entry(k.entry) for k in kernels.KERNELS.values()})
    monkeypatch.setattr(kernels, "lib", lambda: {src: lib for src in kernels.SOURCES})
    monkeypatch.setattr(kernels, "_check", lambda *planes: DEV)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    kernels.reset_counts()
    yield seen
    kernels.reset_counts()


def _pt(*shape):
    return tuple(torch.zeros((16, *shape), dtype=torch.int64, device="meta") for _ in range(3))


def _want(n, wide_from):
    return (0, "wide") if n >= wide_from else (1, "narrow")


@pytest.mark.parametrize("n", kernels.PADD_WIDTHS)
def test_padd_takes_the_design_of_its_lane_count(entries, n):
    kernels.padd(_pt(n), _pt(n))
    narrow, design = _want(n, kernels.PADD_WIDE_LANES)
    (name, args), = entries
    # ..., n, threads, narrow, stream
    assert name == "bppp_padd" and args[-4:-1] == (n, 128, narrow)
    assert kernels.shape_counts()["padd"] == {f"L={n} {design}": 1}


@pytest.mark.parametrize("n", kernels.TABLE_FLAT_WIDTHS)
def test_table_flat_takes_the_design_of_its_lane_count(entries, n):
    kernels.table_flat(_pt(n))
    narrow, design = _want(n, kernels.TABLE_FLAT_WIDE_LANES)
    (name, args), = entries
    assert name == "bppp_table_flat" and args[-3:-1] == (n, narrow)
    assert kernels.shape_counts()["table_flat"] == {f"L={n} {design}": 1}


@pytest.mark.parametrize("kernel", ["padd", "table_flat"])
def test_threshold_is_the_first_wide_lane_count(entries, kernel):
    """One lane under the threshold runs narrow, the threshold wide; the
    main paths' commonest widths (fold's 16-lane tables, the 1,056-lane
    halving tree) run narrow and the bench's 65,536 lanes wide."""
    wide_from = getattr(kernels, f"{kernel.upper()}_WIDE_LANES")
    for n in (wide_from - 1, wide_from, 16, 1056, 65536):
        kernels.reset_counts()
        if kernel == "padd":
            kernels.padd(_pt(n), _pt(n))
        else:
            kernels.table_flat(_pt(n))
        assert kernels.shape_counts()[kernel] == {f"L={n} {_want(n, wide_from)[1]}": 1}
    assert _want(16, wide_from)[1] == _want(1056, wide_from)[1] == "narrow"
    assert _want(65536, wide_from)[1] == "wide"


@pytest.mark.parametrize("kernel", ["padd", "table_flat"])
def test_thresholds_lie_between_measured_widths(kernel):
    """Each threshold is a width the smoke times both designs at, with a
    narrower one measured below it."""
    wide_from = getattr(kernels, f"{kernel.upper()}_WIDE_LANES")
    widths = getattr(kernels, f"{kernel.upper()}_WIDTHS")
    assert wide_from in widths and min(widths) < wide_from < max(widths)
    assert list(widths) == sorted(set(widths))


def test_padd_counts_the_lanes_of_a_batch_shape(entries):
    """The halving tree's (16, B, 33, h) planes: B * 33 * h lanes."""
    kernels.padd(_pt(2, 33, 16), _pt(2, 33, 16))
    assert entries[0][1][-4] == 1056
    assert kernels.shape_counts()["padd"] == {"L=1056 narrow": 1}


@pytest.mark.parametrize("threads", kernels.PADD_THREADS)
def test_padd_threads_reach_the_wide_design_unchanged(entries, threads):
    kernels.padd(_pt(65536), _pt(65536), threads)
    kernels.padd_design(_pt(64), _pt(64), False, threads)
    assert [args[-4:-1] for _, args in entries] == [(65536, threads, 0), (64, threads, 0)]
    assert kernels.shape_counts()["padd"] == {"L=65536 wide": 1, "L=64 wide": 1}


@pytest.mark.parametrize("narrow", [False, True])
def test_design_entries_pass_the_design(entries, narrow):
    kernels.padd_design(_pt(66), _pt(66), narrow)
    kernels.table_flat_design(_pt(64), narrow)
    assert [(name, args[-2]) for name, args in entries] == [("bppp_padd", int(narrow)),
                                                            ("bppp_table_flat", int(narrow))]
    design = "narrow" if narrow else "wide"
    assert kernels.shape_counts()["padd"] == {f"L=66 {design}": 1}
    assert kernels.shape_counts()["table_flat"] == {f"L=64 {design}": 1}


@pytest.mark.parametrize("threads", [0, 64, 2048])
def test_padd_design_refuses_other_block_sizes(entries, threads):
    """Both designs check ``threads``, though only the wide one uses it."""
    for narrow in (False, True):
        with pytest.raises(ValueError, match="threads"):
            kernels.padd_design(_pt(16), _pt(16), narrow, threads)
    assert entries == []


def test_cpu_tensors_take_the_plain_version_whatever_the_design():
    """On the CPU both design entries give the plain version's output."""
    p = curve.identity((4,), "cpu")
    for narrow in (False, True):
        assert all(torch.equal(a, b) for a, b in
                   zip(kernels.table_flat_design(p, narrow), kernels.table_flat_plain(p)))
        assert all(torch.equal(a, b) for a, b in
                   zip(kernels.padd_design(p, p, narrow), kernels.padd_plain(p, p)))


def _rb_want(w, f):
    return _want(w // f, kernels.REDUCE_BLOCK_WIDE_LANES)


@pytest.mark.parametrize("w,f", kernels.REDUCE_BLOCK_WIDTHS)
def test_reduce_block_takes_the_design_of_its_output_lanes(entries, w, f):
    kernels.reduce_block(_pt(w), f)
    narrow, design = _rb_want(w, f)
    (name, args), = entries
    # ..., w, factor, narrow, stream
    assert name == "bppp_reduce_block" and args[-4:-1] == (w, f, narrow)
    assert kernels.shape_counts()["reduce_block"] == {f"W={w} f={f} {design}": 1}


@pytest.mark.parametrize("f", [2, 4, 8])
def test_reduce_block_threshold_is_the_first_wide_output_lane_count(entries, f):
    """One block of output lanes (128) under the threshold runs narrow, the
    threshold wide, whatever the factor."""
    wide_from = kernels.REDUCE_BLOCK_WIDE_LANES
    for n_out, design in ((wide_from - 128, "narrow"), (wide_from, "wide"), (128, "narrow")):
        kernels.reset_counts()
        kernels.reduce_block(_pt(n_out * f), f)
        assert kernels.shape_counts()["reduce_block"] == {f"W={n_out * f} f={f} {design}": 1}


def test_reduce_block_threshold_lies_between_measured_widths():
    """The threshold in output lanes lies between two of the widths the
    smoke times both designs at, one of which is the threshold: a width
    under it and one from it, so that both picks are measured."""
    outs = sorted({w // f for w, f in kernels.REDUCE_BLOCK_WIDTHS})
    wide_from = kernels.REDUCE_BLOCK_WIDE_LANES
    assert wide_from % 128 == 0 and outs[0] < wide_from <= outs[-1]
    below = max(n for n in outs if n < wide_from)
    above = min(n for n in outs if n >= wide_from)
    assert below < wide_from <= above
    assert list(kernels.REDUCE_BLOCK_WIDTHS) == sorted(set(kernels.REDUCE_BLOCK_WIDTHS))
    assert all(f in (2, 4, 8) and w % (128 * f) == 0 for w, f in kernels.REDUCE_BLOCK_WIDTHS)


@pytest.mark.parametrize("narrow", [False, True])
@pytest.mark.parametrize("f", [2, 4, 8])
def test_reduce_block_design_passes_the_design(entries, narrow, f):
    kernels.reduce_block_design(_pt(1024 * f), f, narrow)
    (name, args), = entries
    assert name == "bppp_reduce_block" and args[-4:-1] == (1024 * f, f, int(narrow))
    design = "narrow" if narrow else "wide"
    assert kernels.shape_counts()["reduce_block"] == {f"W={1024 * f} f={f} {design}": 1}


@pytest.mark.parametrize("w,f", [(1000, 2), (1024, 3), (1536, 8)])
def test_reduce_block_design_refuses_widths_off_its_blocks(entries, w, f):
    for narrow in (False, True):
        with pytest.raises(ValueError, match="multiple of 128"):
            kernels.reduce_block_design(_pt(w), f, narrow)
    assert entries == []


@pytest.mark.parametrize("f", [2, 4, 8])
def test_reduce_block_cpu_tensors_take_the_plain_version_whatever_the_design(f):
    """Seeded projective lanes: both design entries give the plain
    version's words."""
    from bulletproofspp_tpu_torch.ops import limb

    rng = np.random.default_rng(f)
    p = tuple(torch.as_tensor(rng.integers(0, 1 << 16, size=(16, 128 * f))) for _ in range(3))
    want = kernels.reduce_block_plain(p, f)
    launched = kernels.counts()["reduce_block"]
    for narrow in (False, True):
        got = kernels.reduce_block_design(p, f, narrow)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(g.shape == (limb.NLIMB, 128) for g in want)
    assert kernels.counts()["reduce_block"] == launched  # nothing launched
