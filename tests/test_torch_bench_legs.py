"""The port's bench legs (``bulletproofspp_tpu_torch.bench``: proofs, mixed,
serve, batch and their BENCH_FULL / BENCH_ONLY selection) against the JAX
package's root ``bench.py``, loaded under a name of its own.

Both run on their ``HostEngine`` at tiny sizes (the batch leg also on
``TorchEngine("cpu")``): the proof bytes of the batch leg's generator, the
key set of each leg's line, the mixed leg's items and the validity of each
leg are held equal, exactly.  No time is asserted.
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import pytest
import torch

from bulletproofspp_tpu.core import engine as jax_engine
from bulletproofspp_tpu.core import lockstep as jax_lockstep
from bulletproofspp_tpu_torch import bench, bounds
from bulletproofspp_tpu_torch.core import engine as torch_engine
from bulletproofspp_tpu_torch.core import lockstep as torch_lockstep
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's sizes cut to a few proofs; literal keys keep their names
TINY = {"BENCH_PROOFS": "2", "BENCH_FULL_REPS": "1", "BENCH_LOCKSTEP_N": "2",
        "BENCH_PROVE_THREADS": "2", "BENCH_MIXED_N": "1", "BENCH_SERVE_N": "5",
        "BENCH_SERVE_CLIENTS": "2", "BENCH_BATCH_N": "2"}
BENCH_ENV = (*TINY, "BENCH_ONLY", "BENCH_FULL")
CARD = {"name": "no card (CPU test)", "power_limit_w": 0.0, "sm_clock_max_mhz": 0.0}
LEGS = {"proofs": "bench_proofs", "mixed": "bench_mixed", "serve": "bench_serve",
        "batch": "bench_batch_1024"}


def load_reference(mp):
    """The root bench as module ``reference_bench``; BPPP_ENGINE is set
    (through ``mp``) first, so that its import's setdefault and its
    generator's write are undone with ``mp``."""
    mp.setenv("BPPP_ENGINE", "host")
    spec = importlib.util.spec_from_file_location("reference_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def last_stderr_json(fn, *args, **kwargs):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args, **kwargs)
    return json.loads(err.getvalue().strip().splitlines()[-1]), out


def clear_bench_env(mp):
    for name in BENCH_ENV:
        mp.delenv(name, raising=False)


@pytest.fixture(scope="module")
def ref_blobs():
    """Proofs 0 and 1 of the root bench's batch generator."""
    with pytest.MonkeyPatch.context() as mp:
        return load_reference(mp)._gen_proof_chunk((0, 2))


@pytest.fixture(scope="module")
def lines(ref_blobs):
    """{leg: (the reference's line, the port's line, the port's return)},
    each on its HostEngine at TINY sizes, the batch leg over ref_blobs."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        clear_bench_env(mp)
        for name, value in TINY.items():
            mp.setenv(name, value)
        ref = load_reference(mp)  # reads BENCH_FULL_REPS when imported
        mp.setattr(jax_engine, "_default_engine", jax_engine.HostEngine())
        mp.setattr(ref, "_load_or_gen_proofs", lambda n: list(ref_blobs))
        mp.setattr(bench, "_load_or_gen_proofs", lambda n: list(ref_blobs))
        mp.setattr(bounds, "card", lambda: CARD)
        for leg, fn in LEGS.items():
            ref_line, _ = last_stderr_json(getattr(ref, fn))
            port_line, got = last_stderr_json(getattr(bench, fn), torch_engine.HostEngine())
            out[leg] = (ref_line, port_line, got)
    return out


def test_gen_proof_chunk_equals_the_reference_byte_for_byte(ref_blobs):
    got = bench._gen_proof_chunk((0, 2))
    assert len(got) == 2
    assert got == ref_blobs


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_line_has_the_reference_keys_and_is_valid(lines, leg):
    ref_line, port_line, got = lines[leg]
    assert set(port_line) == set(ref_line) | {"card", "power_limit_w"}
    assert port_line == got  # what the leg prints is what it returns
    assert (port_line["card"], port_line["power_limit_w"]) == (CARD["name"], CARD["power_limit_w"])
    valid = bench.LEGS[leg][1]
    assert ref_line[valid] is True and port_line[valid] is True


def test_leg_sizes_follow_the_environment(lines):
    assert (lines["proofs"][1]["n"], lines["proofs"][1]["full_reps"]) == (2, 1)
    assert lines["mixed"][1]["mixed_n"] == lines["mixed"][0]["mixed_n"] == 4
    assert lines["batch"][1]["batch_n"] == 2


def test_serve_leg_splits_requests_unevenly_over_clients(lines):
    """5 requests over 2 clients (3 and 2): every prove answered, and every
    verify of them valid, so each proof was paired with its own schema."""
    port_line = lines["serve"][1]
    assert (port_line["serve_n"], port_line["serve_clients"]) == (5, 2)
    assert port_line["serve_all_valid"] is True
    assert port_line["serve_mean_batch"] > 0


class _Stop(Exception):
    pass


def _record_items(mp, module, seen: list):
    def fake(items, engine, *a, **k):
        for setup, values, seed in items:
            seen.append((type(setup).__name__, setup.h, setup.g, len(setup.gs), values, seed))
        raise _Stop

    mp.setattr(module, "prove_many", fake)


def test_mixed_items_equal_the_reference(monkeypatch):
    """The (schema, values, seed) sequence the mixed leg hands prove_many,
    at the reference's default BENCH_MIXED_N (nothing is proved)."""
    clear_bench_env(monkeypatch)
    ref = load_reference(monkeypatch)
    monkeypatch.setattr(jax_engine, "_default_engine", jax_engine.HostEngine())
    want, got = [], []
    _record_items(monkeypatch, jax_lockstep, want)
    _record_items(monkeypatch, torch_lockstep, got)
    with pytest.raises(_Stop):
        ref.bench_mixed()
    with pytest.raises(_Stop):
        bench.bench_mixed(torch_engine.HostEngine())
    assert len(want) == 32
    assert got == want


def test_batch_leg_on_torch_cpu_and_its_exit_code(ref_blobs, monkeypatch):
    """TorchEngine("cpu") over the two proofs: valid; with one byte of proof
    1 flipped, not valid, and the bench under BENCH_ONLY=batch exits 1."""
    clear_bench_env(monkeypatch)
    monkeypatch.setenv("BENCH_FULL_REPS", "1")
    monkeypatch.setattr(bounds, "card", lambda: CARD)
    eng = TorchEngine("cpu")
    line, _ = last_stderr_json(bench.bench_batch_1024, eng, blobs=ref_blobs)
    assert (line["batch_n"], line["batch_all_valid"]) == (2, True)

    coms, proof = ref_blobs[1]
    flipped = bytearray(proof)
    flipped[31] ^= 1
    bad = [ref_blobs[0], (coms, bytes(flipped))]
    line, _ = last_stderr_json(bench.bench_batch_1024, eng, blobs=bad)
    assert line["batch_all_valid"] is False

    monkeypatch.setenv("BENCH_ONLY", "batch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch_engine, "_default_engine", eng)
    monkeypatch.setattr(bench, "_load_or_gen_proofs", lambda n: bad)
    assert last_stderr_json(bench.main)[1] == 1


def test_unknown_bench_only_name_raises(monkeypatch):
    clear_bench_env(monkeypatch)
    monkeypatch.setenv("BENCH_ONLY", "serve,proof")
    with pytest.raises(SystemExit, match=r"BENCH_ONLY: unknown bench\(es\) \['proof'\]"):
        bench.main()


@pytest.mark.parametrize("env", [{}, {"BENCH_FULL": "1"}, {"BENCH_ONLY": "batch"},
                                 {"BENCH_ONLY": "msm,serve"}])
def test_no_cuda_exits_2(monkeypatch, env):
    clear_bench_env(monkeypatch)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "run", lambda: pytest.fail("the MSM ran without CUDA"))
    assert bench.main() == 2


@pytest.mark.parametrize("env,want", [
    ({}, {"msm"}),
    ({"BENCH_FULL": "1"}, {"msm", "proofs", "mixed", "serve", "batch"}),
    ({"BENCH_ONLY": " serve, batch ,"}, {"serve", "batch"}),
    ({"BENCH_ONLY": "msm", "BENCH_FULL": "1"}, {"msm"}),  # BENCH_ONLY wins, as in the reference
    ({"BENCH_ONLY": ","}, set()),
])
def test_selected_legs(monkeypatch, env, want):
    clear_bench_env(monkeypatch)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert bench.selected() == want


@pytest.mark.parametrize("msm_ok,bad_leg,rc", [(True, None, 0), (False, None, 1),
                                               (True, "serve", 1)])
def test_full_runs_the_legs_in_order_and_prints_the_msm_line_last(
        monkeypatch, capsys, msm_ok, bad_leg, rc):
    clear_bench_env(monkeypatch)
    monkeypatch.setenv("BENCH_FULL", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    order = []
    out = {"metric": "msm_32768pt_throughput", "card": CARD["name"], "power_limit_w": 700.0,
           "points_per_s_tabled": 2.5e7, "bound_share_tabled": 0.16, "vs_host_engine": 30.0,
           "correct": msm_ok, "iqr_ok": True, "back_to_back": True}

    def msm_run():
        order.append("msm")
        return out

    monkeypatch.setattr(bench, "run", msm_run)
    for name, (_, valid) in list(bench.LEGS.items()):
        def leg(name=name, valid=valid):
            order.append(name)
            return {valid: name != bad_leg}
        monkeypatch.setitem(bench.LEGS, name, (leg, valid))
    assert bench.main() == rc
    assert order == ["msm", "proofs", "mixed", "serve", "batch"]
    stdout = capsys.readouterr().out.strip().splitlines()
    assert stdout == [f"{CARD['name']}, 700.00 W", bench.line(out)]
