"""Structured metrics & profiling (SURVEY §5: the reference has only
``--verbosity`` prints, reference: app/Main.hs:214-239; production needs
proofs/sec, verifies/sec, MSM lanes/s and kernel traces).

Lightweight process-global counters + timers.  Device traces come from
``torch.profiler`` (``bulletproofspp_tpu_torch.engine_profile``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_counters: dict = defaultdict(int)
_timers: dict = defaultdict(float)


def count(name: str, n: int = 1):
    with _lock:
        _counters[name] += n


@contextlib.contextmanager
def timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _timers[name] += dt
            _counters[name + ".calls"] += 1


def snapshot() -> dict:
    with _lock:
        out = {"counters": dict(_counters), "seconds": dict(_timers)}
    rates = {}
    for k, secs in out["seconds"].items():
        calls = out["counters"].get(k + ".calls", 0)
        if secs > 0 and calls:
            rates[k + ".per_sec"] = calls / secs
    out["rates"] = rates
    return out


def reset():
    with _lock:
        _counters.clear()
        _timers.clear()
