"""The port's copy of the protocol layer (``bulletproofspp_tpu_torch.core``,
``.io_``, ``.cli``) against the JAX package's: the same proof bytes from
both HostEngines on the same seeds (and the golden digests of
tests/test_golden.py), the same batch verdicts, and, in a subprocess, that
importing every module of the port loads nothing of JAX or of the JAX
package.  The two layers define different classes, so the comparisons are
of bytes and verdicts, not objects."""

import hashlib
import json
import pathlib
import subprocess
import sys

import pytest

from bulletproofspp_tpu import cli as jcli
from bulletproofspp_tpu.core import batch as jbatch
from bulletproofspp_tpu.core import range_proof as jrpm
from bulletproofspp_tpu.core.engine import HostEngine as JHostEngine
from bulletproofspp_tpu.io_ import schema as jschema
from bulletproofspp_tpu_torch import cli
from bulletproofspp_tpu_torch.core import batch
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.io_ import schema

from test_golden import GOLDEN  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"


def _setup(name, sch, load_points):
    spec = sch.parse_spec(json.loads((EXAMPLES / name / "schema.json").read_text()))
    return spec, sch.build_setup(spec, load_points(spec, sch.points_needed(spec)))


def _prove(name, sch, mod_cli, prm, eng):
    spec, setup = _setup(name, sch, mod_cli.load_points)
    wit = sch.parse_witness(json.loads((EXAMPLES / name / "witness.json").read_text()))
    proof = prm.prove(setup, mod_cli._resolve_values(spec, wit), spec.random_seed.encode(), eng)
    return prm.encode_proof(setup, proof)


@pytest.mark.parametrize("name", ["32bit", "64bit", "bin_test", "rec_test"])
def test_port_host_engine_proof_bytes_equal_the_jax_package(name):
    coms_b, proof_b = _prove(name, schema, cli, rpm, HostEngine())
    assert (coms_b, proof_b) == _prove(name, jschema, jcli, jrpm, JHostEngine())
    want_proof, want_coms, size = GOLDEN[name]
    assert hashlib.sha256(proof_b).hexdigest() == want_proof and len(proof_b) == size
    assert hashlib.sha256(coms_b).hexdigest() == want_coms


def test_batch_verdicts_equal_the_jax_package():
    spec, setup = _setup("64bit", schema, cli.load_points)
    _, jsetup = _setup("64bit", jschema, jcli.load_points)
    blobs = []
    for i in range(3):
        values = cli._resolve_values(spec, schema.parse_witness([{"amount": 7 + i}]))
        blobs.append(rpm.encode_proof(setup, rpm.prove(setup, values, f"core{i}".encode(),
                                                       HostEngine())))
    flipped = bytearray(blobs[1][1])
    flipped[31] ^= 1
    for pairs, want in ((blobs, [True] * 3),
                        ([blobs[0], (blobs[1][0], bytes(flipped)), blobs[2]], [True, False, True])):
        port = [(setup, c, p) for c, p in pairs]
        ref = [(jsetup, c, p) for c, p in pairs]
        assert batch.verify_many_encoded(port, HostEngine()) == want
        assert jbatch.verify_many_encoded(ref, JHostEngine()) == want
        assert batch.batch_verify_encoded(port, HostEngine()) is all(want)
        assert jbatch.batch_verify_encoded(ref, JHostEngine()) is all(want)


def test_importing_the_port_loads_nothing_of_jax_or_the_jax_package():
    script = (
        "import importlib, pkgutil, sys\n"
        "import bulletproofspp_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bulletproofspp_tpu')))\n"
    )
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    count, loaded = res.stdout.strip().splitlines()[-2:]
    assert int(count) >= 30  # core, io_, ops, tools and the entry points
    assert loaded == "[]"
