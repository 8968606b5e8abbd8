"""The port's schema-bucketed mixed-batch prover
(``bulletproofspp_tpu_torch.core.lockstep.prove_many``): the cases of
tests/test_prove_many.py on the port's HostEngine, proof bytes equal to
sequential proving and to the JAX package's ``prove_many``; and the port's
CLI ``prove-batch`` on the CPU (``--device cpu``: TorchEngine's plain
versions), byte-equal to sequential proving, and refusing to run without
CUDA when no device is given."""

import json
import pathlib

import pytest
import torch

from bulletproofspp_tpu.cli import _resolve_values as j_resolve_values
from bulletproofspp_tpu.core import range_proof as jrpm
from bulletproofspp_tpu.core.engine import HostEngine as JHostEngine
from bulletproofspp_tpu.core.lockstep import prove_many as j_prove_many
from bulletproofspp_tpu.io_ import schema as jschema
from bulletproofspp_tpu_torch import cli
from bulletproofspp_tpu_torch.cli import _resolve_values
from bulletproofspp_tpu_torch.core import engine as engine_mod
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.lockstep import _chunks_pow2, fusion_signature, prove_many
from bulletproofspp_tpu_torch.core.transcript import take_points
from bulletproofspp_tpu_torch.io_ import schema as schema_mod

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
ENGINE = HostEngine()


def _example(name):
    return tuple(json.loads((EXAMPLES / name / f).read_text())
                 for f in ("schema.json", "witness.json"))


EX_32BIT, WIT_32BIT = _example("32bit")
EX_64BIT, WIT_64BIT = _example("64bit")
EX_BIN, WIT_BIN = _example("bin_test")
EX_REC, WIT_REC = _example("rec_test")


def _setup(spec_obj, seed=None, sch=schema_mod):
    spec = sch.parse_spec(spec_obj)
    basis = (seed if seed is not None else spec.basis_seed).encode()
    points = take_points(basis, sch.points_needed(spec))
    return spec, sch.build_setup(spec, points)


def _items(spec_obj, wit_base, setup_seed, n, tag, sch=schema_mod, resolve=_resolve_values):
    spec, setup = _setup(spec_obj, setup_seed, sch)
    out = []
    for i in range(n):
        wit = [dict(w) for w in wit_base]
        out.append((setup, resolve(spec, sch.parse_witness(wit)), f"{tag}{i}".encode()))
    return out


def test_chunks_pow2():
    assert [len(c) for c in _chunks_pow2(list(range(13)), 16)] == [8, 4, 1]
    assert [len(c) for c in _chunks_pow2(list(range(16)), 16)] == [16]
    assert [len(c) for c in _chunks_pow2(list(range(37)), 16)] == [16, 16, 4, 1]
    assert _chunks_pow2([], 16) == []
    # chunks partition the input in order
    assert sum(_chunks_pow2(list(range(13)), 16), []) == list(range(13))


def test_signature_groups_same_schema_across_basis_seeds():
    _, s1 = _setup(EX_32BIT, "seedA")
    _, s2 = _setup(EX_32BIT, "seedB")
    assert s1 is not s2
    assert fusion_signature(s1) == fusion_signature(s2)


def test_signature_separates_different_schemas():
    sigs = {fusion_signature(_setup(e)[1]) for e in (EX_32BIT, EX_64BIT, EX_BIN, EX_REC)}
    assert len(sigs) == 4


def _mixed(sch=schema_mod, resolve=_resolve_values):
    """Interleaved 32bit / 64bit / rec_test / bin_test items, including two
    DIFFERENT setups of the same 32bit schema (they must fuse)."""
    items = []
    items += _items(EX_32BIT, WIT_32BIT, "sA", 2, "a", sch, resolve)
    items += _items(EX_64BIT, WIT_64BIT, None, 3, "b", sch, resolve)
    items += _items(EX_32BIT, WIT_32BIT, "sB", 1, "c", sch, resolve)  # same schema, other basis
    items += _items(EX_REC, WIT_REC, None, 2, "d", sch, resolve)
    items += _items(EX_BIN, WIT_BIN, None, 1, "e", sch, resolve)
    # shuffle deterministically so buckets interleave
    order = [4, 0, 7, 2, 5, 8, 1, 6, 3]
    return [items[i] for i in order]


def test_prove_many_mixed_schemas_matches_sequential():
    items = _mixed()
    sequential = [rpm.prove(s, v, seed, ENGINE) for s, v, seed in items]
    batched = prove_many(items, ENGINE)
    jitems = _mixed(jschema, j_resolve_values)
    ref = j_prove_many(jitems, JHostEngine())
    assert len(batched) == len(items)
    for (setup, _v, _s), (jsetup, _jv, _js), a, b, c in zip(items, jitems, sequential, batched, ref):
        assert rpm.encode_proof(setup, a) == rpm.encode_proof(setup, b)
        assert rpm.encode_proof(setup, b) == jrpm.encode_proof(jsetup, c)
        assert rpm.verify(setup, b, ENGINE)


def test_prove_many_nonpow2_single_schema():
    items = _items(EX_32BIT, WIT_32BIT, None, 5, "x")  # chunks 4 + 1
    sequential = [rpm.prove(s, v, seed, ENGINE) for s, v, seed in items]
    batched = prove_many(items, ENGINE)
    for (setup, _v, _s), a, b in zip(items, sequential, batched):
        assert rpm.encode_proof(setup, a) == rpm.encode_proof(setup, b)


def test_prove_many_empty_and_single():
    assert prove_many([], ENGINE) == []
    [(setup, v, s)] = _items(EX_32BIT, WIT_32BIT, None, 1, "z")
    [p] = prove_many([(setup, v, s)], ENGINE)
    assert rpm.verify(setup, p, ENGINE)


@pytest.fixture
def fresh_default_engine(monkeypatch):
    monkeypatch.setattr(engine_mod, "_default_engine", None)  # restored after the test


def test_cli_prove_batch_on_cpu_equals_sequential(tmp_path, fresh_default_engine, capsys):
    """Two 32bit items through TorchEngine("cpu") in lockstep: the files
    equal sequential proving with seeds <randomSeed>#0 and #1."""
    spec_path, wit_path = (str(EXAMPLES / "32bit" / f) for f in ("schema.json", "witness.json"))
    out = tmp_path / "out"
    rc = cli.main(["prove-batch", spec_path, wit_path, spec_path, wit_path,
                   "--out-dir", str(out), "--device", "cpu"])
    assert rc == 0 and "Wrote 2 proofs" in capsys.readouterr().out
    spec, setup = _setup(EX_32BIT)
    values = _resolve_values(spec, schema_mod.parse_witness(WIT_32BIT))
    for i in range(2):
        coms_b, proof_b = rpm.encode_proof(
            setup, rpm.prove(setup, values, f"{spec.random_seed}#{i}".encode(), ENGINE))
        assert (out / f"commits_{i}.bin").read_bytes() == coms_b
        assert (out / f"proof_{i}.bin").read_bytes() == proof_b


def test_cli_prove_batch_refuses_bad_arguments(tmp_path, fresh_default_engine, capsys):
    spec_path = str(EXAMPLES / "32bit" / "schema.json")
    assert cli.main(["prove-batch", spec_path, "--device", "cpu"]) == 2
    assert "alternating" in capsys.readouterr().err
    bad = tmp_path / "witness.json"
    bad.write_text(json.dumps([{"amount": 1}, {"amount": 2}]))
    assert cli.main(["prove-batch", spec_path, str(bad), "--out-dir", str(tmp_path),
                     "--device", "cpu"]) == 2
    assert "different number of values and ranges" in capsys.readouterr().err


def test_cli_prove_batch_needs_cuda_by_default(fresh_default_engine, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec_path, wit_path = (str(EXAMPLES / "32bit" / f) for f in ("schema.json", "witness.json"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["prove-batch", spec_path, wit_path])
