"""The bench's profile check: the device kernels a profile holds are matched
to the port's wrappers by the ``__global__`` functions each wrapper's launch
runs (``kernels.KERNELS[...].device_kernels``).  On the CPU: every listed
function exists in its source file, and ``engine_profile.profile_complete``
reads stubbed ``torch.profiler`` events as ``engine_profile.device_time``
keys them."""

import os
import re
import types

import pytest
from torch.autograd import DeviceType

from bulletproofspp_tpu_torch import engine_profile
from bulletproofspp_tpu_torch.engine_profile import by_wrapper, device_time, wrappers_of
from bulletproofspp_tpu_torch.ops import kernels


def _globals(source):
    with open(os.path.join(kernels.CSRC, source)) as f:
        text = f.read()
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text))


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_device_kernels_are_global_functions_of_the_wrappers_source(name):
    k = kernels.KERNELS[name]
    listed = {f for group in k.device_kernels for f in group.split("|")}
    assert listed and listed <= _globals(k.source)


def _prof(*events, host=()):
    """A finished profile stub: (key as the profiler demangles it, launches)
    of the device's events, and of the host's (``host``: the profiler gives
    them device time too)."""
    evs = [types.SimpleNamespace(key=key, self_device_time_total=10.0 * n, count=n,
                                 device_type=DeviceType.CUDA) for key, n in events]
    evs += [types.SimpleNamespace(key=key, self_device_time_total=10.0 * n, count=n,
                                  device_type=DeviceType.CPU)
            for key, n in [("aten::add", 1), *host]]
    return types.SimpleNamespace(key_averages=lambda: evs)


_TAIL = "(anonymous namespace)::tail_rows_kernel(long const*, long const*, long)"
_HORNER = "(anonymous namespace)::horner_warp_kernel(long const*, long const*, long, long)"
_REDUCE = "void (anonymous namespace)::reduce_block_kernel<8>(long const*, long const*, long)"
_REDUCE_NARROW = _REDUCE.replace("reduce_block_kernel<8>", "reduce_block_narrow_kernel<2>")
_STAGED = "(anonymous namespace)::select_reduce_kernel(long const*, long, long, long)"
_ROWS = "(anonymous namespace)::select_reduce_rows_kernel(long const*, long, long, long)"
_TF_WIDE = "(anonymous namespace)::table_flat_kernel(long const*, long*, long)"
_TF_NARROW = "(anonymous namespace)::table_flat_narrow_kernel(long const*, long*, long)"
_PADD_WIDE = "void (anonymous namespace)::padd_kernel<128>(long const*, long*, long)"
_PADD_NARROW = "(anonymous namespace)::padd_narrow_kernel(long const*, long*, long)"
_TORCH = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long>>(int)"
_COPY = "Memcpy HtoD (Pageable -> Device)"

CASES = {
    # tail_horner runs two device kernels a launch; horner shares the second
    "tail_horner and horner": ({"tail_horner": 2, "horner": 3, "reduce_block": 4},
                               [(_TAIL, 2), (_HORNER, 5), (_REDUCE, 4), (_TORCH, 9), (_COPY, 3)],
                               True),
    "one tail_horner": ({"tail_horner": 1}, [(_TAIL, 1), (_HORNER, 1)], True),
    "a missing horner_warp_kernel": ({"tail_horner": 2, "horner": 3},
                                     [(_TAIL, 2), (_HORNER, 4)], False),
    "two instantiations of a template": ({"reduce_block": 3},
                                         [(_REDUCE, 2), (_REDUCE.replace("<8>", "<4>"), 1)], True),
    "one launch too many": ({"horner": 3}, [(_HORNER, 4)], False),
    # select_reduce runs one of its two designs a launch
    "both select_reduce designs": ({"select_reduce": 3}, [(_STAGED, 2), (_ROWS, 1)], True),
    "a missing select_reduce": ({"select_reduce": 3}, [(_STAGED, 2)], False),
    # padd and table_flat run one of their two designs a launch
    "both designs of padd and table_flat": ({"padd": 5, "table_flat": 4},
                                            [(_PADD_WIDE, 1), (_PADD_NARROW, 4), (_TF_WIDE, 1),
                                             (_TF_NARROW, 3)], True),
    # reduce_block runs one of its two designs a launch, each a template
    "both designs of reduce_block": ({"reduce_block": 4}, [(_REDUCE, 1), (_REDUCE_NARROW, 3)],
                                     True),
    "a missing narrow table_flat": ({"table_flat": 4}, [(_TF_WIDE, 1), (_TF_NARROW, 2)], False),
    "no port kernel in the profile": ({"reduce_block": 1}, [(_TORCH, 1)], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_profile_complete_matches_launches_by_device_kernel(case):
    launched, events, want = CASES[case]
    _, by_kernel = device_time(_prof(*events), top=None)
    assert engine_profile.profile_complete(launched, by_kernel) is want


SHORTFALLS = {
    "tail_horner and horner": {},
    "a missing horner_warp_kernel": {"horner_warp_kernel": 1},
    "one launch too many": {"horner_warp_kernel": -1},
    "a missing narrow table_flat": {"table_flat_kernel|table_flat_narrow_kernel": 1},
    "no port kernel in the profile": {"reduce_block_kernel|reduce_block_narrow_kernel": 1},
}


@pytest.mark.parametrize("case", sorted(SHORTFALLS))
def test_profile_shortfall_names_the_missing_launches(case):
    launched, events, _ = CASES[case]
    _, by_kernel = device_time(_prof(*events), top=None)
    assert engine_profile.profile_shortfall(launched, by_kernel) == SHORTFALLS[case]


def test_profiled_call_starts_after_the_profiler_settles(monkeypatch):
    """engine_profile.profiled waits PROFILE_SETTLE_S between the profiler's
    start and fn's first launch (a launch right at the start has been lost
    from the profile), and the wait is not in the wall seconds."""
    import contextlib
    import time

    import torch

    marks = {}

    @contextlib.contextmanager
    def stub_profile(**_):
        marks["start"] = time.perf_counter()
        yield _prof()

    monkeypatch.setattr(torch.profiler, "profile", stub_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    p = engine_profile.profiled(lambda: marks.setdefault("fn", time.perf_counter()))
    assert marks["fn"] - marks["start"] >= engine_profile.PROFILE_SETTLE_S > 0
    assert p["wall_s"] < engine_profile.PROFILE_SETTLE_S
    assert p["launched"] == {} and p["complete"]


def test_device_time_by_wrapper_sums_both_designs():
    """engine_profile's by_wrapper: a wrapper's time and launches summed over
    its device kernels (both designs); a kernel two wrappers run counts for
    both; library kernels for none of them but under "library", copies
    nowhere."""
    _, by_kernel = device_time(_prof((_TF_WIDE, 1), (_TF_NARROW, 3), (_PADD_NARROW, 2),
                                     (_HORNER, 4), (_TAIL, 1), (_TORCH, 9), (_COPY, 3)), top=None)
    assert by_wrapper(by_kernel) == {"table_flat": [40.0 / 1e3, 4], "padd": [20.0 / 1e3, 2],
                                     "horner": [40.0 / 1e3, 4], "tail_horner": [50.0 / 1e3, 5],
                                     "library": [90.0 / 1e3, 9]}
    _, ours = device_time(_prof((_PADD_NARROW, 2), (_COPY, 3)), top=None)
    assert by_wrapper(ours) == {"padd": [20.0 / 1e3, 2], "library": [0.0, 0]}


def test_copies_by_kind():
    """engine_profile.copies: the memory copies by_wrapper leaves out, ms and
    count by kind (assemble's tables were the pinned host-to-device copies
    of a prove; the digits' uploads are pageable)."""
    _, by_kernel = device_time(_prof((_COPY, 3), ("Memcpy HtoD (Pinned -> Device)", 2),
                                     ("Memcpy DtoH (Device -> Pageable)", 1), (_TORCH, 9)),
                               top=None)
    assert engine_profile.copies(by_kernel) == {
        "HtoD (Pageable -> Device)": [30.0 / 1e3, 3], "HtoD (Pinned -> Device)": [20.0 / 1e3, 2],
        "DtoH (Device -> Pageable)": [10.0 / 1e3, 1]}
    assert engine_profile.copies(device_time(_prof((_TORCH, 9)), top=None)[1]) == {}


def test_device_time_leaves_out_runtime_calls():
    """A process's first profile gives ``cudaLaunchKernel`` a little device
    time and one count a launch, and the profiler's buffer request some:
    neither is a kernel, neither counts in the time or the library's
    launches."""
    device_s, by_kernel = device_time(_prof((_PADD_NARROW, 2), ("Activity Buffer Request", 1),
                                            (_TORCH, 9), host=[("cudaLaunchKernel", 563)]),
                                      top=None)
    assert set(by_kernel) == {"padd_narrow_kernel", _TORCH.split("(")[0]}
    assert device_s == (20.0 + 90.0) / 1e6
    assert by_wrapper(by_kernel)["library"] == [90.0 / 1e3, 9]


@pytest.mark.parametrize("event, want", [
    (_PADD_WIDE, {"padd": "padd_kernel|padd_narrow_kernel"}),
    (_PADD_NARROW, {"padd": "padd_kernel|padd_narrow_kernel"}),
    (_TF_NARROW, {"table_flat": "table_flat_kernel|table_flat_narrow_kernel"}),
    (_REDUCE, {"reduce_block": "reduce_block_kernel|reduce_block_narrow_kernel"}),
    (_REDUCE_NARROW, {"reduce_block": "reduce_block_kernel|reduce_block_narrow_kernel"}),
    (_HORNER, {"horner": "horner_warp_kernel", "tail_horner": "horner_warp_kernel"}),
    (_TORCH, {}),
    (_COPY, {}),
])
def test_wrappers_of_a_profiled_kernel(event, want):
    """The one rule that ties a profiled kernel to the wrappers whose launch
    runs it, for both ``profile_complete`` and ``by_wrapper``."""
    (key,) = device_time(_prof((event, 1)), top=None)[1]
    assert wrappers_of(key) == want


def test_a_kernel_named_like_a_runtime_call_still_counts():
    """What counts is where an event ran, not its name: a device kernel
    whose name starts with "cuda" is device work and library time; a host
    call with device time is neither."""
    device_s, by_kernel = device_time(_prof(("cudaish_fill_kernel(long*)", 2),
                                            host=[("cudaStreamSynchronize", 3)]), top=None)
    assert by_kernel == {"cudaish_fill_kernel": [20.0 / 1e3, 2]}
    assert device_s == 20.0 / 1e6
    assert by_wrapper(by_kernel)["library"] == [20.0 / 1e3, 2]


@pytest.mark.parametrize("names", [("select_small", "endo", "pneg", "normalize3"),
                                   ("assemble", "reduce_lanes")])
def test_plain_versions_swaps_the_wrappers_for_the_block(names):
    """engine_profile.plain_versions: inside the block kernels.NAME is
    NAME_plain, after it (also after an error) the wrapper again."""
    from bulletproofspp_tpu_torch.ops import kernels

    wrappers = {name: getattr(kernels, name) for name in names}
    with pytest.raises(RuntimeError):
        with engine_profile.plain_versions(names):
            assert all(getattr(kernels, n) is getattr(kernels, f"{n}_plain") for n in names)
            raise RuntimeError
    assert {name: getattr(kernels, name) for name in names} == wrappers


def test_plain_names_are_accepted_on_the_command_line():
    """``--plain assemble --plain reduce_lanes`` parse (every kernel of
    KERNELS is a choice); without a card the run then stops before it
    profiles anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("runs the whole profile where a card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        engine_profile.main(["--plain", "assemble", "--plain", "reduce_lanes"])
    with pytest.raises(SystemExit):
        engine_profile.main(["--plain", "no_such_kernel"])


def test_the_plain_route_of_the_two_reaches_their_plain_versions(monkeypatch):
    """Inside ``plain_versions(("assemble", "reduce_lanes"))`` the engine's
    assembly and the small MSMs' lane tree call assemble_plain and
    reduce_lanes_plain (looked up at call time), and a 64bit prove on
    TorchEngine("cpu") keeps its golden bytes."""
    import hashlib

    from bulletproofspp_tpu_torch.core import range_proof as rpm
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    reached = {"assemble_plain": 0, "reduce_lanes_plain": 0}
    for name in reached:
        inner = getattr(kernels, name)

        def counted(*a, _inner=inner, _name=name, **k):
            reached[_name] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(kernels, name, counted)
    spec, setup, values = engine_profile._load("64bit")
    with engine_profile.plain_versions(("assemble", "reduce_lanes")):
        proof = rpm.prove(setup, values, spec.random_seed.encode(), TorchEngine("cpu"))
    assert hashlib.sha256(rpm.encode_proof(setup, proof)[1]).hexdigest() == (
        "fe39faef84b016b82b017a4ef07ba3f31c5237b0f79c0653376c86f5dbba8c5d")
    assert all(reached.values()), reached
