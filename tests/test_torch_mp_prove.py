"""The port's multiparty range prover (``core/mp_prove.py``).

N parties each hold a disjoint subset of an aggregated schema's ranges and
jointly produce ONE standard proof through the dealer combinators.  The
JAX package's twelve cases of tests/test_mp_prove.py and the multiparty
case of tests/test_random_schemas.py run here on the port's modules and
its ``HostEngine``; then, exactly:

* ``rec_test`` and ``bin_test`` over 2 parties with fixed seeds, the
  dealer on ``TorchEngine("cpu")`` and the parties on ``HostEngine``, give
  the JAX package's proof bytes (its ``party_prove`` / ``dealer_prove`` on
  its ``HostEngine`` with the same seeds);
* one party owning every range of ``32bit``, dealer and party on
  ``TorchEngine("cpu")``, gives ``range_proof.prove``'s bytes, the golden
  ones.
"""

import copy
import hashlib
import json
import pathlib
import random
import threading

import pytest

from bulletproofspp_tpu import cli as jcli
from bulletproofspp_tpu.core import mp_prove as jmp_prove
from bulletproofspp_tpu.core import multiparty as jmultiparty
from bulletproofspp_tpu.core import range_proof as jrpm
from bulletproofspp_tpu.core.engine import HostEngine as JHostEngine
from bulletproofspp_tpu.io_ import schema as jschema
from bulletproofspp_tpu_torch import cli
from bulletproofspp_tpu_torch.core import mp_prove, multiparty
from bulletproofspp_tpu_torch.core import range_proof as rpm
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.mp_prove import dealer_prove, party_prove
from bulletproofspp_tpu_torch.core.multiparty import LocalChannel
from bulletproofspp_tpu_torch.io_ import schema as schema_mod
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

from test_golden import GOLDEN  # noqa: E402

ENGINE = HostEngine()
EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    return tuple(json.loads((EXAMPLES / name / f).read_text())
                 for f in ("schema.json", "witness.json"))


def _setup_values(spec_obj, wit_obj, cli_mod=cli, schema=schema_mod):
    spec = schema.parse_spec(spec_obj)
    setup = schema.build_setup(spec, cli_mod.load_points(spec, schema.points_needed(spec)))
    values = cli_mod._resolve_values(spec, schema.parse_witness(wit_obj))
    return spec, setup, values


def _run_mp(setup, values, partition, seeds=None, channel_wrap=None, party_eng=ENGINE,
            dealer_eng=ENGINE, mods=(mp_prove, multiparty)):
    """partition: one list of range indices a party.  The parties and the
    dealer on threads of package ``mods`` (its mp_prove and multiparty
    modules); returns the proof."""
    mp_mod, mpty = mods
    channels = []
    threads = []
    errors = []
    for k, part in enumerate(partition):
        ch = mpty.LocalChannel()
        if channel_wrap is not None:
            ch = channel_wrap(k, ch)
        channels.append(ch)
        owned = {i: values[i] for i in part}
        seed = (seeds[k] if seeds else f"mp party {k}").encode()

        def work(ch=ch, owned=owned, seed=seed):
            try:
                mp_mod.party_prove(setup, ch, owned, seed, party_eng)
            except Exception as exc:  # surfaced below
                errors.append(exc)

        th = threading.Thread(target=work, daemon=True)
        th.start()
        threads.append(th)
    # the dealer on a thread too: if a party dies, run_dealer would block on
    # its channel forever, so the party's exception is raised instead
    result = {}

    def dealer_work():
        try:
            result["proof"] = mp_mod.dealer_prove(setup, channels, dealer_eng)
        except Exception as exc:  # surfaced below
            errors.append(exc)

    dth = threading.Thread(target=dealer_work, daemon=True)
    dth.start()
    for th in threads + [dth]:
        th.join(timeout=300)
    if errors:
        raise errors[0]
    if "proof" not in result:
        raise TimeoutError("multiparty run deadlocked (no party error reported)")
    return result["proof"]


def test_mp_single_party_byte_parity():
    """One party owning all ranges reproduces the single prover's proof
    bytes exactly (same randomness seed => same transcript)."""
    spec, setup, values = _setup_values(*_example("32bit"))
    solo = rpm.prove(setup, values, spec.random_seed.encode(), ENGINE)
    mp = _run_mp(setup, values, [list(range(len(values)))], seeds=[spec.random_seed])
    assert rpm.encode_proof(setup, mp) == rpm.encode_proof(setup, solo)
    assert rpm.verify(setup, mp, ENGINE)


def test_mp_two_party_shared_digits():
    """4x32-bit shared-digit aggregate, split 2+2: shared multiplicity
    slots receive additive contributions from BOTH parties."""
    spec_obj = {
        "argument": "NL",
        "basisSeed": "mp test basis",
        "randomSeed": "mp test rand",
        "ranges": [{"count": 4, "max": 2**32, "isShared": True, "base": 16}],
    }
    wit_obj = [{"amount": a} for a in (0, 77, 2**31 + 5, 2**32 - 1)]
    spec, setup, values = _setup_values(spec_obj, wit_obj)
    proof = _run_mp(setup, values, [[0, 2], [1, 3]])
    assert rpm.verify(setup, proof, ENGINE)
    # wire round-trip through the standard encoder/decoder
    coms_b, proof_b = rpm.encode_proof(setup, proof)
    dec = rpm.decode_proof(setup, coms_b, proof_b, ENGINE)
    assert dec is not None and rpm.verify(setup, dec, ENGINE)


def test_mp_three_party_typed_conserved():
    """The typed rec_test fixture (shared bases 3 and 16, one assumed
    range, a public value) split across 3 parties: type conservation is a
    JOINT property that only holds on the aggregate."""
    spec, setup, values = _setup_values(*_example("rec_test"))
    assert len(values) == 3
    proof = _run_mp(setup, values, [[0], [1], [2]])
    assert rpm.verify(setup, proof, ENGINE)


def test_mp_broken_conservation_fails():
    """A party misdeclaring its type total produces a proof that fails
    verification (no party can check conservation locally)."""
    spec_obj, wit = _example("rec_test")
    wit = copy.deepcopy(wit)
    wit[1]["amount"] = int(wit[1]["amount"]) + 1  # still in range, breaks sum
    spec, setup, values = _setup_values(spec_obj, wit)
    proof = _run_mp(setup, values, [[0], [1], [2]])
    assert not rpm.verify(setup, proof, ENGINE)


class _Tamper:
    """A party's channel that shifts one slot of its final witness share
    by 1 (``index``); the dealer side passes through."""

    def __init__(self, inner, index):
        self.inner, self.index = inner, index

    def send(self, msg):
        if msg[0] == "done":
            ops = list(msg[1])
            ops[self.index] = int(ops[self.index]) + 1
            msg = ("done", ops)
        self.inner.send(msg)

    def recv(self):
        return self.inner.recv()

    def dealer_send(self, m):
        self.inner.dealer_send(m)

    def dealer_recv(self):
        return self.inner.dealer_recv()


def test_mp_tampered_share_fails():
    """A corrupted witness share from one party must yield an invalid proof
    (dealer soundness is unconditional).  Index 1 is the first LIN slot:
    index 0, the tracked scalar, never travels (the verifier recomputes it
    from the verification equation), so tampering it is harmless."""
    spec, setup, values = _setup_values(*_example("32bit"))
    proof = _run_mp(setup, values, [list(range(len(values)))],
                    channel_wrap=lambda k, ch: _Tamper(ch, 1))
    assert not rpm.verify(setup, proof, ENGINE)


def test_mp_unowned_range_aborts():
    """A range owned by nobody leaves the identity in the aggregated
    input-commitment vector; the dealer must abort, not emit a proof."""
    spec_obj = {
        "basisSeed": "mp test basis 2",
        "randomSeed": "mp test rand 2",
        "ranges": [{"count": 2, "max": 2**16}],
    }
    spec, setup, values = _setup_values(spec_obj, [{"amount": 3}, {"amount": 9}])
    channels = [LocalChannel()]
    th = threading.Thread(
        target=lambda: party_prove(setup, channels[0], {0: values[0]}, b"p0", ENGINE),
        daemon=True,
    )
    th.start()
    with pytest.raises(ValueError):
        dealer_prove(setup, channels, ENGINE)


def test_mp_out_of_range_value_rejected_locally():
    """make_phase1s rejects an out-of-range owned value before anything is
    sent."""
    spec_obj = {
        "basisSeed": "mp test basis 3",
        "randomSeed": "mp test rand 3",
        "ranges": [{"count": 1, "max": 2**16}],
    }
    spec, setup, _ = _setup_values(spec_obj, [{"amount": 1}])
    ch = LocalChannel()
    with pytest.raises(ValueError):
        party_prove(setup, ch, {0: ((2**16, 0), 12345)}, b"p0", ENGINE)
    assert ch.to_dealer.empty()


# ---------------------------------------------------------------------------
# binary protocol family (reference: src/RangeProof/Binary.hs)
# ---------------------------------------------------------------------------


def test_mp_binary_single_party_byte_parity():
    spec, setup, values = _setup_values(*_example("bin_test"))
    solo = rpm.prove(setup, values, spec.random_seed.encode(), ENGINE)
    mp = _run_mp(setup, values, [list(range(len(values)))], seeds=[spec.random_seed])
    assert rpm.encode_proof(setup, mp) == rpm.encode_proof(setup, solo)


def test_mp_binary_two_party():
    spec_obj = {
        "binary": True,
        "basisSeed": "mp bin basis",
        "randomSeed": "mp bin rand",
        "ranges": [{"count": 4, "max": 2**32}],
    }
    wit_obj = [{"amount": a} for a in (1, 0, 2**31, 2**32 - 1)]
    spec, setup, values = _setup_values(spec_obj, wit_obj)
    proof = _run_mp(setup, values, [[0, 3], [1, 2]])
    assert rpm.verify(setup, proof, ENGINE)
    coms_b, proof_b = rpm.encode_proof(setup, proof)
    dec = rpm.decode_proof(setup, coms_b, proof_b, ENGINE)
    assert dec is not None and rpm.verify(setup, dec, ENGINE)


def test_mp_binary_assumed_range():
    """Assumed binary ranges commit no digits; the compacted row layout and
    the unowned blinding-tail rows must still verify under MPC."""
    spec_obj = {
        "binary": True,
        "basisSeed": "mp bin assumed",
        "randomSeed": "mp bin assumed rand",
        "ranges": [
            {"max": 2**16},
            {"max": 2**8, "isAssumed": True},
            {"max": 2**16},
        ],
    }
    wit_obj = [{"amount": 1234}, {"amount": 77}, {"amount": 999}]
    spec, setup, values = _setup_values(spec_obj, wit_obj)
    proof = _run_mp(setup, values, [[0, 1], [2]])
    assert rpm.verify(setup, proof, ENGINE)


def test_mp_binary_tampered_share_fails():
    """A corrupted binary witness share (its last norm row) must yield an
    invalid proof."""
    spec, setup, values = _setup_values(*_example("bin_test"))
    proof = _run_mp(setup, values, [list(range(len(values)))],
                    channel_wrap=lambda k, ch: _Tamper(ch, -1))
    assert not rpm.verify(setup, proof, ENGINE)


def test_mp_binary_broken_conservation_fails():
    """Binary conservation (cons) is enforced by the x-weighted input
    coefficients; no party can check it locally, and a violated sum yields
    a failing proof."""
    spec_obj = {
        "binary": True,
        "conserved": True,
        "basisSeed": "mp bin cons",
        "randomSeed": "mp bin cons rand",
        "ranges": [{"max": 2**16}, {"max": 2**16, "isOutput": True}],
    }
    spec, setup, values = _setup_values(spec_obj, [{"amount": 500}, {"amount": 500}])
    good = _run_mp(setup, values, [[0], [1]])
    assert rpm.verify(setup, good, ENGINE)
    spec, setup, values = _setup_values(spec_obj, [{"amount": 500}, {"amount": 501}])
    bad = _run_mp(setup, values, [[0], [1]])
    assert not rpm.verify(setup, bad, ENGINE)


def test_random_schemas_through_multiparty_prover():
    """tests/test_random_schemas.py's multiparty case on the port: a random
    partition of random schemas' ranges (both protocol families) across 1-3
    parties verifies, and one party owning everything gives the single
    prover's bytes."""
    from test_random_schemas import _gen_case

    rng = random.Random(0x3A9B)
    for _ in range(6):
        spec_obj, wit = _gen_case(rng)
        spec, setup, vals = _setup_values(spec_obj, wit)
        n = len(vals)
        # random partition into 1..min(3, n) non-empty parts
        idx = list(range(n))
        rng.shuffle(idx)
        n_parties = rng.randint(1, min(3, n))
        parts = [idx[k::n_parties] for k in range(n_parties)]
        proof = _run_mp(setup, vals, parts)
        assert rpm.verify(setup, proof, ENGINE), (spec_obj, parts)
        if n_parties == 1:
            solo = rpm.prove(setup, vals, b"mp party 0", ENGINE)
            assert rpm.encode_proof(setup, proof) == rpm.encode_proof(setup, solo)


# ---------------------------------------------------------------------------
# against the JAX package, and through TorchEngine on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rec_test", "bin_test"])
def test_two_parties_equal_the_jax_package_byte_for_byte(name):
    spec_obj, wit_obj = _example(name)
    _spec, setup, values = _setup_values(spec_obj, wit_obj)
    _jspec, jsetup, jvalues = _setup_values(spec_obj, wit_obj, jcli, jschema)
    parts = cli.mp_partition(len(values), 2)
    seeds = [f"{name} party {k}" for k in range(2)]
    got = _run_mp(setup, values, parts, seeds, dealer_eng=TorchEngine("cpu"))
    want = _run_mp(jsetup, jvalues, parts, seeds, party_eng=JHostEngine(),
                   dealer_eng=JHostEngine(), mods=(jmp_prove, jmultiparty))
    assert rpm.encode_proof(setup, got) == jrpm.encode_proof(jsetup, want)
    assert rpm.verify(setup, got, ENGINE)


def test_single_party_on_torch_engine_gives_the_golden_32bit_bytes():
    spec, setup, values = _setup_values(*_example("32bit"))
    eng = TorchEngine("cpu")
    mp = _run_mp(setup, values, [list(range(len(values)))], seeds=[spec.random_seed],
                 party_eng=eng, dealer_eng=eng)
    coms_b, proof_b = rpm.encode_proof(setup, mp)
    assert (coms_b, proof_b) == rpm.encode_proof(
        setup, rpm.prove(setup, values, spec.random_seed.encode(), ENGINE))
    want_proof, want_coms, _ = GOLDEN["32bit"]
    assert (hashlib.sha256(proof_b).hexdigest(), hashlib.sha256(coms_b).hexdigest()) == \
        (want_proof, want_coms)


def test_parties_and_dealer_on_one_torch_engine_under_fast_thread_switches():
    """``mp-prove --local``'s route: 3 parties and the dealer share one
    TorchEngine("cpu") (its basis cache, the launch counts) while the
    interpreter switches threads every few microseconds; the proof equals
    the HostEngine run's byte for byte."""
    import sys

    spec, setup, values = _setup_values(*_example("rec_test"))
    seeds = [f"switch party {k}" for k in range(3)]
    eng = TorchEngine("cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = _run_mp(setup, values, [[0], [1], [2]], seeds, party_eng=eng, dealer_eng=eng)
    finally:
        sys.setswitchinterval(interval)
    want = _run_mp(setup, values, [[0], [1], [2]], seeds)
    assert rpm.encode_proof(setup, got) == rpm.encode_proof(setup, want)
