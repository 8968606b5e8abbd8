"""The verifier's batch path through TorchEngine on the CPU: device
decompression against HostEngine and JaxEngine, the plain decompress
against the JAX decompress_kernel on every lane (non-residues included),
batch_verify_encoded and verify_many_encoded verdicts against HostEngine's
on three 64bit proofs and their corrupted and truncated variants, the
port's CLI batch-verify, and engine_profile's batch mode.
tests/test_batch_decode.py is the template."""

import json
import pathlib
import random

import numpy as np
import pytest
import torch

from bulletproofspp_tpu.cli import _resolve_values
from bulletproofspp_tpu.core import ec
from bulletproofspp_tpu.core import range_proof as rpm
from bulletproofspp_tpu.core.batch import batch_verify_encoded, verify_many_encoded
from bulletproofspp_tpu.core.encoding import x_and_sign
from bulletproofspp_tpu.core.engine import HostEngine
from bulletproofspp_tpu.core.fields import Q
from bulletproofspp_tpu.core.transcript import take_points
from bulletproofspp_tpu.io_ import schema as schema_mod
from bulletproofspp_tpu_torch import cli
from bulletproofspp_tpu_torch.core import engine as engine_mod
from bulletproofspp_tpu_torch.ops import curve, kernels, limb
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

SCHEMA = pathlib.Path(__file__).resolve().parent.parent / "examples" / "64bit" / "schema.json"
HOST = HostEngine()


def _xs_with_non_residues(n_points, n_bad, seed):
    rng = random.Random(seed)
    pts = [ec.scalar_mul(rng.randrange(1, ec.R), ec.G) for _ in range(n_points)]
    xs, signs = (list(v) for v in zip(*[x_and_sign(p) for p in pts]))
    x = 5  # non-residue x's decode to None
    while len(xs) < n_points + n_bad:
        if ec.point_x(x) is None:
            xs.append(x)
            signs.append(False)
        x += 1
    return pts, xs, signs


def test_torch_decompress_matches_host_and_jax():
    from bulletproofspp_tpu.ops.engine import JaxEngine

    pts, xs, signs = _xs_with_non_residues(40, 5, 7)
    want = HOST.decompress(xs, signs)
    assert want[:40] == pts and want[40:] == [None] * 5
    kernels.reset_counts()
    assert TorchEngine("cpu").decompress(xs, signs) == want
    assert kernels.counts()["decompress"] == 0  # the plain version on a CPU tensor
    assert JaxEngine(host_below=0).decompress(xs, signs) == want


def test_decompress_plain_matches_jax_decompress_kernel_on_every_lane():
    """y and ok lane by lane, so y on non-residue lanes is held too."""
    import jax.numpy as jnp

    from bulletproofspp_tpu.ops import curve as jcurve

    rng = np.random.default_rng(8)
    xs = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(61)] + [0, 1, Q - 1]
    sign = rng.integers(0, 2, size=64)
    x = limb.from_ints(xs, "cpu")
    y, ok = curve.decompress(x, torch.as_tensor(sign))
    jy, jok = jcurve.decompress_kernel(jnp.asarray(limb.pack_ints(xs)), jnp.asarray(sign.astype(np.uint32)))
    assert np.array_equal(limb.planes_to_numpy(y), np.asarray(jy))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < int(ok.sum()) < 64  # both kinds of lane present
    for xv, yv, good in zip(xs, limb.unpack_ints(y), ok.tolist()):
        assert good == (ec.point_x(xv) is not None)
        assert not good or (yv * yv - xv**3 - 7) % Q == 0


@pytest.fixture(scope="module")
def proofs():
    """Three distinct 64bit proofs (amount 10^9 + i, seed bench<i>) as wire bytes."""
    spec = schema_mod.parse_spec(json.loads(SCHEMA.read_text()))
    setup = schema_mod.build_setup(
        spec, take_points(spec.basis_seed.encode(), schema_mod.points_needed(spec))
    )
    blobs = []
    for i in range(3):
        values = _resolve_values(spec, schema_mod.parse_witness([{"amount": 10**9 + i}]))
        blobs.append(rpm.encode_proof(setup, rpm.prove(setup, values, f"bench{i}".encode(), HOST)))
    return setup, blobs


def _variants(blobs):
    flipped = bytearray(blobs[1][1])
    flipped[31] ^= 1  # low byte of the first witness scalar: decodes, does not verify
    return {
        "valid": blobs,
        "flipped": [blobs[0], (blobs[1][0], bytes(flipped)), blobs[2]],
        "truncated": [blobs[0], blobs[1], (blobs[2][0], blobs[2][1][:-1])],
    }


def test_batch_verdicts_match_host(proofs):
    setup, blobs = proofs
    eng = TorchEngine("cpu")
    want = {"valid": [True] * 3, "flipped": [True, False, True], "truncated": [True, True, False]}
    for name, pairs in _variants(blobs).items():
        entries = [(setup, c, p) for c, p in pairs]
        many = verify_many_encoded(entries, eng)
        assert many == verify_many_encoded(entries, HOST) == want[name], name
        assert batch_verify_encoded(entries, eng) is batch_verify_encoded(entries, HOST) is all(many)


def test_cli_batch_verify_on_cpu(proofs, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(engine_mod, "_default_engine", None)  # restored after the test
    _, blobs = proofs
    for name, want_rc in (("valid", 0), ("flipped", 1), ("truncated", 1)):
        files = []
        for i, (coms_b, proof_b) in enumerate(_variants(blobs)[name]):
            for kind, data in (("coms", coms_b), ("proof", proof_b)):
                path = tmp_path / f"{name}_{kind}{i}.bin"
                path.write_bytes(data)
                files.append(str(path))
        rc = cli.main(["batch-verify", str(SCHEMA), *files, "--device", "cpu"])
        assert rc == want_rc, name
        assert capsys.readouterr().out.strip().splitlines()[-1] == f"Batch of 3: {want_rc == 0}"
    assert isinstance(engine_mod.default_engine(), TorchEngine)


def test_engine_profile_batch_mode_on_cpu(proofs):
    """engine_profile --batch's timing loop: one decompress and one merged
    MSM per batch verify, with their sizes."""
    from bulletproofspp_tpu_torch import engine_profile

    _, blobs = proofs  # wire bytes; the setup is the port's own
    setup = engine_profile._load("64bit")[1]
    row = next(engine_profile.run_batch(setup, blobs, engine_profile.TimedEngine("cpu"), 1))
    assert row["batch"] == 3 and row["decompressed_points"] == 3 * 11
    assert row["msm_points"] == 23 + 3 * 11 and row["msm_lanes"] == 128  # 23 shared basis points
    assert sorted(row["by_call"]) == ["decompress", "msm"]
    assert all(calls == 1 for _, calls in row["by_call"].values())
