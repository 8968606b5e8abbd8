"""The port's lockstep prover (``bulletproofspp_tpu_torch.core.lockstep``):
the cases of tests/test_lockstep.py on the port's HostEngine (proof bytes
equal to sequential proving and to the JAX package's lockstep prover),
``TorchEngine("cpu").fold_bv_many`` and ``complete_square_many`` (the plain
versions of the batched fold) against their single-call versions and
against ``JaxEngine(host_below=0)``'s on the same seeded points and
scalars, exactly, and a prover that raises mid-proof."""

import json
import pathlib
import random
import threading

import pytest

from bulletproofspp_tpu.cli import _resolve_values as j_resolve_values
from bulletproofspp_tpu.core import ec as jec
from bulletproofspp_tpu.core import range_proof as jrpm
from bulletproofspp_tpu.core.engine import HostEngine as JHostEngine
from bulletproofspp_tpu.core.lockstep import prove_lockstep as j_prove_lockstep
from bulletproofspp_tpu.io_ import schema as jschema
from bulletproofspp_tpu.ops.engine import JaxEngine
from bulletproofspp_tpu_torch.cli import _resolve_values
from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.lockstep import prove_lockstep, prove_many
from bulletproofspp_tpu_torch.core.transcript import take_points
from bulletproofspp_tpu_torch.io_ import schema as schema_mod
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

from torch_threads import one_thread  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
ENGINE = HostEngine()


def _example(name):
    return tuple(json.loads((EXAMPLES / name / f).read_text())
                 for f in ("schema.json", "witness.json"))


def _setup(spec_obj, sch=schema_mod):
    spec = sch.parse_spec(spec_obj)
    points = take_points(spec.basis_seed.encode(), sch.points_needed(spec))
    return spec, sch.build_setup(spec, points)


def _vals(spec, wit, resolve=_resolve_values, sch=schema_mod):
    return resolve(spec, sch.parse_witness(wit))


@pytest.mark.parametrize("name", ["64bit", "rec_test"])
def test_lockstep_matches_sequential(name):
    spec_obj, wit_base = _example(name)
    spec, setup = _setup(spec_obj)
    jspec, jsetup = _setup(spec_obj, jschema)
    items, jitems = [], []
    for i in range(4):
        wit = [dict(w) for w in wit_base]
        if name == "64bit":
            wit[0]["amount"] = 10_000 + i
        items.append((_vals(spec, wit), f"seed{i}".encode()))
        jitems.append((_vals(jspec, wit, j_resolve_values, jschema), f"seed{i}".encode()))
    sequential = [rpm.prove(setup, v, s, ENGINE) for v, s in items]
    lock = prove_lockstep(setup, items, ENGINE)
    ref = j_prove_lockstep(jsetup, jitems, JHostEngine())
    for a, b, c in zip(sequential, lock, ref):
        assert rpm.encode_proof(setup, a) == rpm.encode_proof(setup, b)
        assert rpm.encode_proof(setup, b) == jrpm.encode_proof(jsetup, c)
    for p in lock:
        assert rpm.verify(setup, p, ENGINE)


def test_lockstep_bad_witness_poisons_cleanly():
    spec, setup = _setup(_example("32bit")[0])
    good = (_vals(spec, [{"amount": 10}]), b"s0")
    bad = (_vals(spec, [{"amount": 2**62}]), b"s1")  # out of 32-bit range
    with pytest.raises(ValueError):
        prove_lockstep(setup, [good, bad, good], ENGINE)


def test_lockstep_single_and_empty():
    spec, setup = _setup(_example("32bit")[0])
    assert prove_lockstep(setup, [], ENGINE) == []
    [p] = prove_lockstep(setup, [(_vals(spec, [{"amount": 5}]), b"z")], ENGINE)
    assert rpm.verify(setup, p, ENGINE)


class _DiesMidProof(HostEngine):
    """HostEngine whose first prover thread to reach its third basis split
    raises there: outside any rendezvous, with the other provers blocked at
    the next fused call."""

    def __init__(self):
        self.splits = {}
        self.lock = threading.Lock()

    def bv_split(self, bv):
        with self.lock:
            me = threading.get_ident()
            self.splits[me] = self.splits.get(me, 0) + 1
            doomed = self.splits[me] == 3 and self.__dict__.setdefault("doomed", me) == me
        if doomed:
            raise RuntimeError("prover died mid-proof")
        return super().bv_split(bv)


def test_prover_dying_mid_proof_poisons_the_rendezvous():
    """Every prover thread returns, and prove_many raises the error."""
    spec, setup = _setup(_example("32bit")[0])
    items = [(setup, _vals(spec, [{"amount": 10 + i}]), f"d{i}".encode()) for i in range(4)]
    eng = _DiesMidProof()
    out = {}

    def run():
        try:
            out["proofs"] = prove_many(items, eng)
        except BaseException as e:  # noqa: BLE001 - checked below
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "a prover thread blocked on the poisoned rendezvous"
    assert isinstance(out.get("error"), RuntimeError) and "mid-proof" in str(out["error"])
    assert "doomed" in eng.__dict__


def test_fold_and_square_calls_of_one_round_are_not_merged():
    """The rendezvous keys calls by method and generation: two fold_bv calls
    of a round (gs, then hs) give two batches, each of all provers."""
    batches = []

    class Recorder(HostEngine):
        def fold_bv_many(self, calls):
            batches.append(len(calls))
            return [self.fold_bv(*c) for c in calls]

    spec, setup = _setup(_example("32bit")[0])
    items = [(_vals(spec, [{"amount": 3 + i}]), f"g{i}".encode()) for i in range(3)]
    lock = prove_lockstep(setup, items, Recorder())
    assert batches and set(batches) == {3}
    for (v, s), p in zip(items, lock):
        assert rpm.encode_proof(setup, p) == rpm.encode_proof(setup, rpm.prove(setup, v, s, ENGINE))


def _points(r, n):
    return [ec.scalar_mul(r.randrange(1, ec.R), ec.G) for _ in range(n)]


def _jax_points(pts):
    return [None if p is None else tuple(p) for p in pts]


def test_torch_fold_bv_many_matches_single_and_jax():
    """B = 3 provers, 5 even against 4 odd lanes (16-lane buckets): equal to
    fold_bv per prover and to JaxEngine's fold_bv_many, exactly."""
    r = random.Random(3)
    calls = [(r.randrange(1, 2**120), r.randrange(1, 2**120), _points(r, 5), _points(r, 4))
             for _ in range(3)]
    eng = TorchEngine("cpu")
    fused = eng.fold_bv_many(calls)
    ref = JaxEngine(host_below=0).fold_bv_many(
        [(b, a, _jax_points(e), _jax_points(o)) for b, a, e, o in calls])
    assert len(fused) == len(ref) == 3
    for call, got, want in zip(calls, fused, ref):
        assert len(got) == 5
        assert got.to_host() == eng.fold_bv(*call).to_host()
        assert got.to_host() == [None if p is None else tuple(p) for p in want.to_host()]
        b, a, even, odd = call
        assert got.to_host() == [jec.double_base_mul(b, e, a, o)
                                 for e, o in zip(even, odd + [None])]


def test_torch_complete_square_many_matches_single_and_jax():
    """B = 3 provers, 4 g0 lanes against 3 g1 lanes: equal to
    complete_square per prover and to JaxEngine's complete_square_many."""
    r = random.Random(9)
    calls = [(r.randrange(1, ec.R), _points(r, 4), _points(r, 3)) for _ in range(3)]
    eng = TorchEngine("cpu")
    fused = eng.complete_square_many(calls)
    ref = JaxEngine(host_below=0).complete_square_many(
        [(k, _jax_points(g0), _jax_points(g1)) for k, g0, g1 in calls])
    for call, (gx, hy), (jgx, jhy) in zip(calls, fused, ref):
        wgx, why = eng.complete_square(*call)
        assert gx.to_host() == wgx.to_host() and hy.to_host() == why.to_host()
        assert gx.to_host() == [None if p is None else tuple(p) for p in jgx.to_host()]
        assert hy.to_host() == [None if p is None else tuple(p) for p in jhy.to_host()]


def test_torch_many_methods_refuse_different_shapes():
    r = random.Random(5)
    eng = TorchEngine("cpu")
    with pytest.raises(ValueError, match="lockstep fold requires identical shapes"):
        eng.fold_bv_many([(3, 5, _points(r, 5), _points(r, 4)),
                          (3, 5, _points(r, 4), _points(r, 4))])
    with pytest.raises(ValueError, match="lockstep complete_square requires identical shapes"):
        eng.complete_square_many([(3, _points(r, 4), _points(r, 3)),
                                  (3, _points(r, 2), _points(r, 2))])
    [single] = eng.fold_bv_many([(3, 5, _points(r, 2), _points(r, 2))])
    assert len(single) == 2
