"""TorchEngine end to end on the CPU: golden proof bytes, verification of
HostEngine proofs, the port's CLI, and the promise that the port never
imports JAX (checked in a subprocess: this test process has JAX loaded by
tests/conftest.py)."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from bulletproofspp_tpu.cli import _resolve_values
from bulletproofspp_tpu.core import range_proof as rpm
from bulletproofspp_tpu.core.engine import HostEngine
from bulletproofspp_tpu.core.transcript import take_points
from bulletproofspp_tpu.io_ import schema as schema_mod
from bulletproofspp_tpu_torch import cli
from bulletproofspp_tpu_torch.ops import kernels
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"

GOLDEN = {  # tests/test_golden.py:43-46
    "32bit": ("49602ab782f3dc35343b615c0f85010e7d050fcd16444dca82b07acaa4fb3c5b",
              "ddc048e1dd7c0a88bbcadb02cd4f80d3598a45bb90edd8d05c575da4d723b080"),
    "64bit": ("fe39faef84b016b82b017a4ef07ba3f31c5237b0f79c0653376c86f5dbba8c5d",
              "fd56b4b18729678d4f77a64644771f77ebaf38f686da8523a3fdebcb2d29c8ee"),
}


def _case(name):
    spec = schema_mod.parse_spec(json.loads((EXAMPLES / name / "schema.json").read_text()))
    wit = schema_mod.parse_witness(json.loads((EXAMPLES / name / "witness.json").read_text()))
    setup = schema_mod.build_setup(
        spec, take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
    )
    return spec, setup, _resolve_values(spec, wit)


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_torch_engine_proof_bytes_are_golden(name):
    spec, setup, values = _case(name)
    eng = TorchEngine("cpu")
    proof = rpm.prove(setup, values, spec.random_seed.encode(), eng)
    coms_b, proof_b = rpm.encode_proof(setup, proof)
    assert (_sha(proof_b), _sha(coms_b)) == GOLDEN[name]


def test_torch_engine_verifies_host_proofs_and_rejects_tampering():
    spec, setup, values = _case("64bit")
    proof = rpm.prove(setup, values, spec.random_seed.encode(), HostEngine())
    coms_b, proof_b = rpm.encode_proof(setup, proof)
    eng = TorchEngine("cpu")
    dec = rpm.decode_proof(setup, coms_b, proof_b, eng)
    assert dec is not None and rpm.verify(setup, dec, eng) is True
    bad = bytearray(proof_b)
    bad[31] ^= 1  # low byte of the first witness scalar
    dec = rpm.decode_proof(setup, coms_b, bytes(bad), eng)
    assert dec is not None and rpm.verify(setup, dec, eng) is False


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    return env


def test_cli_test_command_on_cpu(tmp_path):
    for f in ("schema.json", "witness.json"):
        shutil.copy(EXAMPLES / "32bit" / f, tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "bulletproofspp_tpu_torch.cli", "test", "--device", "cpu"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "In-process verify: True" in res.stdout and "Proof from file: True" in res.stdout
    proof_b = (tmp_path / "proof.bin").read_bytes()
    coms_b = (tmp_path / "commits.bin").read_bytes()
    assert (_sha(proof_b), _sha(coms_b)) == GOLDEN["32bit"]


def test_port_never_imports_jax(tmp_path):
    script = (
        "import sys, json\n"
        "import bulletproofspp_tpu_torch.cli, bulletproofspp_tpu_torch.ops.kernels\n"
        "from bulletproofspp_tpu.core import range_proof as rpm\n"
        "from bulletproofspp_tpu.io_ import schema as S\n"
        "from bulletproofspp_tpu.core.transcript import take_points\n"
        "from bulletproofspp_tpu.cli import _resolve_values\n"
        "from bulletproofspp_tpu_torch.ops.engine import TorchEngine\n"
        f"d = {str(EXAMPLES / '32bit')!r}\n"
        "spec = S.parse_spec(json.load(open(d + '/schema.json')))\n"
        "vals = _resolve_values(spec, S.parse_witness(json.load(open(d + '/witness.json'))))\n"
        "setup = S.build_setup(spec, take_points(spec.basis_seed.encode(), S.points_needed(spec)))\n"
        "eng = TorchEngine('cpu')\n"
        "proof = rpm.prove(setup, vals, spec.random_seed.encode(), eng)\n"
        "assert rpm.verify(setup, proof, eng)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_cli_refuses_engine_flag_and_missing_cuda(monkeypatch):
    with pytest.raises(SystemExit):
        cli.main(["test", "--engine", "host"])
    with pytest.raises(SystemExit):
        cli.main(["batch-verify", "schema.json", "--device", "cpu"])
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["test", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchEngine("cuda")


def test_kernel_wrapper_refuses_cpu_launch():
    """The kernels launch only on CUDA tensors; the CPU path is the plain
    version, chosen by the tensor's device alone."""
    import torch

    x = torch.zeros((16, 128), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels._check(x)
