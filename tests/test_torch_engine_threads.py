"""The state that the lockstep prover's threads share through one
``TorchEngine``: its basis cache and the kernel launch counts.  Both must
stay right when many threads use them at once.  To make the threads
interleave inside the code under test, the switch interval is cut and a
trace function runs on every bytecode of that code, so a thread can be
switched out between any two of them (as it can where no lock holds)."""

import sys
import threading

import pytest

from bulletproofspp_tpu_torch.ops import engine as engine_mod
from bulletproofspp_tpu_torch.ops import kernels

THREADS = 16


def _run(threads, target, *traced):
    """Run target(i) on ``threads`` threads, switching between threads at
    any bytecode of the functions ``traced``; returns what they raised."""
    errors = []

    def body(i):
        try:
            target(i)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    codes = {f.__code__ for f in traced}

    def per_opcode(frame, event, arg):
        return per_opcode

    def on_call(frame, event, arg):
        if frame.f_code in codes:
            frame.f_trace_opcodes = True
            return per_opcode
        return None

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threading.settrace(on_call)
    try:
        ts = [threading.Thread(target=body, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        threading.settrace(None)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    return errors


class _Packed:
    """What the stubbed ``basevec`` returns: the list it packed."""

    def __init__(self, pts):
        self.pts = pts


@pytest.mark.parametrize("extra", [1, 2, 16])
def test_basis_cache_shared_by_threads_at_its_bound(monkeypatch, extra):
    """16 threads ask for BV_CACHE_MAX + ``extra`` bases, the same ones from
    different places in the list, and for single points of their own, with
    the cache full, so a basis one thread finds can be the one another
    evicts: no exception, and every answer is the basis asked for."""
    eng = engine_mod.TorchEngine("cpu")
    monkeypatch.setattr(eng, "basevec", lambda pts: _Packed(list(pts)))
    bases = [[(i, 1)] for i in range(engine_mod.BV_CACHE_MAX + extra)]
    for b in bases:
        eng.basevec_cached(b)
    assert len(eng._bv_cache) == engine_mod.BV_CACHE_MAX

    def work(t):
        for rep in range(200):
            b = bases[(7 * t + rep) % len(bases)]
            got = eng.basevec_cached(b)
            if got.pts != b:
                raise AssertionError(f"thread {t}: asked for {b}, got {got.pts}")
            if rep % 10 == 0 and eng.basevec_cached((t, rep)).pts != [(t, rep)]:
                raise AssertionError(f"thread {t}: a single point came back wrong")

    assert _run(THREADS, work, engine_mod.TorchEngine.basevec_cached) == []
    assert len(eng._bv_cache) <= engine_mod.BV_CACHE_MAX


def test_launch_counts_exact_under_threads(monkeypatch):
    """Many threads launch through a stubbed entry: the totals, in all and by
    shape, are exact."""
    entry = type("Lib", (), {"bppp_padd": staticmethod(lambda *a: 0)})()
    monkeypatch.setattr(kernels, "lib", lambda: {src: entry for src in kernels.SOURCES})

    class Guard:
        def __init__(self, dev):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(kernels.torch.cuda, "device", Guard)
    monkeypatch.setattr(kernels.torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    reps = 1000
    kernels.reset_counts()
    try:
        errors = _run(THREADS, lambda t: [kernels._launch("padd", f"L={t % 4}", None)
                                          for _ in range(reps)], kernels._launch)
        assert errors == []
        assert kernels.counts()["padd"] == THREADS * reps
        assert kernels.shape_counts()["padd"] == {f"L={s}": THREADS // 4 * reps for s in range(4)}
    finally:
        kernels.reset_counts()
