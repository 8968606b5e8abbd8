"""The port's CLI multiparty commands on the CPU (``--device cpu``):
``mp-prove`` over TCP party processes (``--party-engine host`` and the
default ``torch``) and with ``--local`` threads, accepted by the port's
``verify``; ``mp-demo`` over TCP and ``--local``; usage errors exit 2, a
party that dies makes the dealer exit 1 with its error, ``--engine`` is
refused, and a ``torch`` party on ``cuda`` without CUDA raises while a
``host`` party never needs CUDA (tests/test_cli.py:150 and :173 are the
JAX package's two mp-prove cases)."""

import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from bulletproofspp_tpu_torch import cli
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.mp_prove import dealer_prove
from bulletproofspp_tpu_torch.core.multiparty import SocketDealerChannel, make_dealer_listener

REPO = pathlib.Path(__file__).resolve().parent.parent

SHARED = {
    "basisSeed": "mp cli basis",
    "randomSeed": "mp cli rand",
    "ranges": [{"count": 4, "max": 2**32, "isShared": True, "base": 16}],
}
SHARED_WIT = [{"amount": a} for a in (5, 6, 7, 2**32 - 2)]
BINARY = {
    "binary": True,
    "basisSeed": "mp cli bin basis",
    "randomSeed": "mp cli bin rand",
    "ranges": [{"max": 2**32}, {"max": 2**16, "isAssumed": True}, {"max": 2**32}],
}
BINARY_WIT = [{"amount": 2**31}, {"amount": 777}, {"amount": 9}]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    # one intra-op thread a process: the dealer and its parties share the
    # test worker's cores
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "bulletproofspp_tpu_torch.cli", *args],
                          cwd=cwd, env=_env(), capture_output=True, text=True, timeout=600)


def _write(d, spec, wit):
    (d / "s.json").write_text(json.dumps(spec))
    (d / "w.json").write_text(json.dumps(wit))


@pytest.mark.parametrize("spec,wit,party_engine", [
    (SHARED, SHARED_WIT, "host"),  # tests/test_cli.py:150
    (BINARY, BINARY_WIT, "torch"),  # tests/test_cli.py:173: an assumed range crosses processes
], ids=["shared-host-parties", "binary-torch-parties"])
def test_cli_mp_prove_over_tcp(tmp_path, spec, wit, party_engine):
    """2 TCP party processes jointly prove; the port's verify accepts the
    files."""
    _write(tmp_path, spec, wit)
    r = _run(["mp-prove", "s.json", "w.json", "c.bin", "p.bin", "--parties", "2",
              "--party-engine", party_engine, "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr + r.stdout
    assert "Multiparty range proof (2 TCP subprocesses): True" in r.stdout
    rv = _run(["verify", "s.json", "c.bin", "p.bin", "--device", "cpu"], tmp_path)
    assert rv.returncode == 0, rv.stderr + rv.stdout
    assert "Proof from file: True" in rv.stdout


def test_cli_mp_prove_local_threads_share_the_dealer_engine(tmp_path):
    _write(tmp_path, SHARED, SHARED_WIT)
    r = _run(["mp-prove", "s.json", "w.json", "c.bin", "p.bin", "--parties", "2", "--local",
              "--device", "cpu"], tmp_path)
    assert r.returncode == 0, r.stderr + r.stdout
    assert "Multiparty range proof (threads): True" in r.stdout
    rv = _run(["verify", "s.json", "c.bin", "p.bin", "--device", "cpu"], tmp_path)
    assert rv.returncode == 0, rv.stderr + rv.stdout


@pytest.mark.parametrize("local", [False, True], ids=["tcp", "local"])
def test_cli_mp_demo(tmp_path, local):
    r = _run(["mp-demo", "--parties", "3", "--device", "cpu"] + (["--local"] if local else []),
             tmp_path)
    assert r.returncode == 0, r.stderr + r.stdout
    mode = "threads" if local else "3 TCP subprocesses"
    assert f"Multiparty opening proof ({mode}): True" in r.stdout


@pytest.mark.parametrize("args,wit", [
    (["--parties", "0"], SHARED_WIT),
    (["--parties", "5"], SHARED_WIT),
    (["--parties", "2"], SHARED_WIT[:3]),  # a witness count mismatch
], ids=["no-parties", "more-parties-than-ranges", "witness-count"])
def test_cli_mp_prove_usage_errors_exit_2(tmp_path, args, wit):
    _write(tmp_path, SHARED, wit)
    r = _run(["mp-prove", "s.json", "w.json", *args, "--party-engine", "host",
              "--device", "cpu"], tmp_path)
    assert r.returncode == 2, r.stderr + r.stdout
    assert not (tmp_path / "proof.bin").exists()


def test_cli_mp_demo_value_count_mismatch_exits_2(tmp_path):
    r = _run(["mp-demo", "--parties", "3", "--values", "1,2", "--local", "--device", "cpu"],
             tmp_path)
    assert r.returncode == 2, r.stderr + r.stdout


def test_cli_mp_prove_dies_with_its_party(tmp_path):
    """Party 1's slice holds an amount out of range: it raises before its
    first message, and the dealer exits 1 with the party's error."""
    _write(tmp_path, SHARED, SHARED_WIT[:3] + [{"amount": 2**32}])
    r = _run(["mp-prove", "s.json", "w.json", "--parties", "2", "--party-engine", "host",
              "--device", "cpu"], tmp_path)
    assert r.returncode == 1, r.stderr + r.stdout
    assert "invalid witness for range 3" in r.stderr
    assert "multiparty run failed" in r.stderr
    assert "Multiparty range proof" not in r.stdout


def test_cli_mp_commands_refuse_the_engine_flag():
    for cmd in (["mp-prove", "--engine", "host"], ["mp-demo", "--engine", "jax"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(cmd + ["--device", "cpu"])
        assert exc.value.code == 2


def test_torch_party_on_cuda_without_cuda_raises(tmp_path, monkeypatch):
    _write(tmp_path, SHARED, SHARED_WIT)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["mp-prove-party", "127.0.0.1", "1", str(tmp_path / "s.json"),
                  str(tmp_path / "w.json"), "0", "2", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["mp-prove", str(tmp_path / "s.json"), str(tmp_path / "w.json"),
                  "--party-engine", "host", "--device", "cuda"])


def test_host_party_process_needs_no_cuda(tmp_path):
    """A ``host`` party spawned with ``--device cuda`` (as the dealer spawns
    it) proves on HostEngine where CUDA is missing; this test is its dealer."""
    _write(tmp_path, SHARED, SHARED_WIT)
    spec, setup, values = cli._mp_prove_load(str(tmp_path / "s.json"), str(tmp_path / "w.json"))
    listener, port = make_dealer_listener()
    listener.settimeout(300)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bulletproofspp_tpu_torch.cli", "mp-prove-party", "127.0.0.1",
         str(port), "s.json", "w.json", "0", "1", "--device", "cuda", "--party-engine", "host"],
        cwd=tmp_path, env=_env(), stderr=subprocess.PIPE, text=True)
    try:
        sock, _ = listener.accept()
        ch = SocketDealerChannel(sock)
        try:
            proof = dealer_prove(setup, [ch], HostEngine())
        finally:
            ch.close()
        assert proc.wait(timeout=120) == 0, proc.stderr.read()
    finally:
        listener.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    assert rpm.verify(setup, proof, HostEngine())


def test_party_partition_is_contiguous_and_even():
    assert cli.mp_partition(128, 4) == [list(range(32 * i, 32 * i + 32)) for i in range(4)]
    assert cli.mp_partition(3, 2) == [[0, 1], [2]]
    assert cli.mp_partition(1, 1) == [[0]]


def test_local_party_failure_is_reported_not_hung(tmp_path, capsys):
    """In --local mode a party thread that raises ends the command with rc 1
    and its error, while the dealer thread still waits on its channel."""
    _write(tmp_path, SHARED, SHARED_WIT[:3] + [{"amount": 2**32}])
    done = threading.Event()
    out = {}

    def run():
        out["rc"] = cli.main(["mp-prove", str(tmp_path / "s.json"), str(tmp_path / "w.json"),
                              str(tmp_path / "c.bin"), str(tmp_path / "p.bin"), "--parties", "2",
                              "--local", "--party-engine", "host", "--device", "cpu"])
        done.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert done.wait(timeout=120)
    assert out["rc"] == 1
    assert "multiparty party 1 failed: invalid witness for range 3" in capsys.readouterr().err
