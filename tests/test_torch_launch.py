"""Kernel launches run under their tensors' device, on that device's current
stream, whatever the process's current device is.  On the CPU: the kernel
libraries and the torch.cuda calls are stubbed, the entries record the
device guard they ran under and the stream they were given, and every
wrapper runs on meta tensors that its device check places on cuda:1
(assemble's segment table travels by value in the launch: no tensor)."""

import types

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch.ops import glv, kernels

DEV1 = torch.device("cuda", 1)


def _stream(dev):
    return 7000 + dev.index  # a stream handle that names its device


@pytest.fixture
def launches(monkeypatch):
    """Stubs lib() and torch.cuda's device guard and current stream; yields
    the list of (kernel entry, device guarded, stream) the entries saw."""
    seen, guard = [], []

    class Device:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            guard.append(self.dev)

        def __exit__(self, *exc):
            guard.pop()

    def current_stream(device=None):
        # no argument: the process's current device, device 0 here
        dev = torch.device("cuda", 0) if device is None else torch.device(device)
        return types.SimpleNamespace(cuda_stream=_stream(dev))

    def entry(name):
        def call(*args):
            seen.append((name, guard[-1] if guard else None, args[-1]))
            return 0
        return call

    lib = types.SimpleNamespace(**{k.entry: entry(k.entry) for k in kernels.KERNELS.values()},
                                bppp_assemble_capacity=lambda: 32712)
    monkeypatch.setattr(kernels, "lib", lambda: {src: lib for src in kernels.SOURCES})
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    kernels.reset_counts()
    yield seen
    kernels.reset_counts()


@pytest.mark.parametrize("index", [0, 1])
def test_launch_takes_the_stream_of_the_tensors_device_under_its_guard(launches, index):
    dev = torch.device("cuda", index)
    kernels._launch("padd", "L=1", dev, 0, 0)
    assert launches == [("bppp_padd", dev, _stream(dev))]
    assert kernels.counts()["padd"] == 1 and kernels.shape_counts()["padd"] == {"L=1": 1}


def test_launch_that_fails_raises_and_is_not_counted(launches, monkeypatch):
    lib = types.SimpleNamespace(bppp_padd=lambda *a: 1)
    monkeypatch.setattr(kernels, "lib", lambda: {src: lib for src in kernels.SOURCES})
    with pytest.raises(RuntimeError, match="cudaError 1"):
        kernels._launch("padd", "L=1", DEV1, 0)
    assert kernels.counts()["padd"] == 0


def _meta(*shape):
    return torch.zeros(shape, dtype=torch.int64, device="meta")


def _pt(*shape):
    return tuple(_meta(16, *shape) for _ in range(3))


def _tables(n):
    return _meta(144, n), _meta(288, n), _meta(144, n)


def _digits(*shape):
    return torch.zeros(shape, dtype=torch.uint8, device="meta")


_DIGITS = np.stack([*glv.recode_signed(3**80), *glv.recode_signed(5**50)])

CALLS = {
    "padd": lambda: kernels.padd(_pt(256), _pt(256)),
    "horner": lambda: kernels.horner(*_pt(2, 33)),
    "reduce_block": lambda: kernels.reduce_block(_pt(1024), 8),
    "tail_horner": lambda: kernels.tail_horner(_pt(1, 2 * 128), 2),
    "table_flat": lambda: kernels.table_flat(_pt(1024)),
    "select_reduce": lambda: kernels.select_reduce(_tables(1024), _digits(1, 3, 1024),
                                                   _digits(1, 3, 1024)),
    "fold": lambda: kernels.fold(_tables(16), _tables(16), _DIGITS),
    "fold_many": lambda: kernels.fold_many(_pt(32), _pt(32), np.stack([_DIGITS] * 2)),
    "complete_square": lambda: kernels.complete_square(_pt(32), _pt(32),
                                                       np.stack([_DIGITS] * 2)),
    "select_reduce_fused": lambda: kernels.select_reduce_fused(_pt(1024), _digits(1, 3, 1024),
                                                               _digits(1, 3, 1024)),
    "decompress": lambda: kernels.decompress(_meta(16, 64), _meta(64)),
    "inv": lambda: kernels.inv(_meta(16, 64)),
    "to_affine": lambda: kernels.to_affine(*_pt(64)),
    "select_small": lambda: kernels.select_small(_tables(2 * 64), _digits(2, 33, 64),
                                                 _digits(2, 33, 64)),
    "endo": lambda: kernels.endo(_pt(64), interleave=True),
    "pneg": lambda: kernels.pneg(_pt(64)),
    "normalize3": lambda: kernels.normalize3(*_pt(64)),
    "assemble": lambda: kernels.assemble([[[tuple(c[:, 1::2] for c in _pt(40))]] * 3], 64, True),
    "reduce_lanes": lambda: kernels.reduce_lanes(_tables(2 * 16), _digits(2, 33, 16),
                                                 _digits(2, 33, 16)),
    "sr_variant": lambda: kernels.sr_variant(_tables(1024), _digits(3, 1024), _digits(3, 1024)),
    "grid_copy": lambda: kernels.grid_copy(_meta(16, 1024)),
    "chain": lambda: kernels.chain("padd", _pt(64), _pt(64)),
}
# the forms of a wrapper that launch its kernel another way: the select in
# reduce_block's and tail_horner's first level, the canonical stores
FORMS = {
    "reduce_block tables": ("reduce_block", lambda: kernels.reduce_block(
        _tables(2 * 256), 2, absd=_digits(2, 33, 256), sgn=_digits(2, 33, 256))),
    "tail_horner tables canonical": ("tail_horner", lambda: kernels.tail_horner(
        _tables(128), 33, canonical=True, absd=_digits(1, 33, 128), sgn=_digits(1, 33, 128))),
    "horner canonical": ("horner", lambda: kernels.horner(*_pt(2, 33), canonical=True)),
}


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_every_wrapper_launches_under_its_tensors_device(launches, monkeypatch, name):
    """The device the wrapper's check returns (cuda:1 here, not the
    process's current device 0) is the one its launch runs under."""
    checked = []

    def check(*planes, contiguous=True):
        checked.append({t.device.type for t in planes})
        return DEV1

    monkeypatch.setattr(kernels, "_check", check)
    CALLS[name]()
    assert checked == [{"meta"}]
    assert launches == [(kernels.KERNELS[name].entry, DEV1, _stream(DEV1))]
    assert kernels.counts()[name] == 1


@pytest.mark.parametrize("form", sorted(FORMS))
def test_every_form_launches_under_its_tensors_device(launches, monkeypatch, form):
    """The same for the from-tables and canonical forms: one launch of the
    wrapper's kernel, under the checked device, its digits as pointers."""
    name, call = FORMS[form]
    monkeypatch.setattr(kernels, "_check", lambda *planes, contiguous=True: DEV1)
    out = call()
    assert launches == [(kernels.KERNELS[name].entry, DEV1, _stream(DEV1))]
    assert kernels.counts()[name] == 1
    if "canonical" in form:
        assert out.shape == (3, 16, 1 if "tail" in form else 2)


@pytest.mark.parametrize("provers", [2, 20])
def test_batched_folds_launch_no_table_flat(launches, monkeypatch, provers):
    """``msm.fold_mul_many`` hands the bases' points to fold_many, which
    builds the tables in its own launch, and ``msm.complete_square_many``
    its points to complete_square, which also makes phi and both sums: the
    counts show one launch per 16 provers of fold_many, then of
    complete_square alone (no table_flat, endo, pneg or padd)."""
    from bulletproofspp_tpu_torch.ops import msm

    monkeypatch.setattr(kernels, "_check", lambda *planes, contiguous=True: DEV1)
    digits = np.stack([_DIGITS] * provers)
    per = -(-provers // kernels.FOLD_MAX_PROVERS)
    msm.fold_mul_many(_pt(provers * 16), _pt(provers * 16), digits)
    assert {k: n for k, n in kernels.counts().items() if n} == {"fold_many": per}
    kernels.reset_counts()
    msm.complete_square_many(_pt(provers * 16), _pt(provers * 16), digits)
    assert {k: n for k, n in kernels.counts().items() if n} == {"complete_square": per}
