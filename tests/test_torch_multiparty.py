"""The port's dealer/client multiparty combinators (``core/multiparty.py``):
the JAX package's five cases of tests/test_multiparty.py run on the port's
module, and the same scripted party messages through both packages'
``run_dealer`` give the same aggregates, rounds and challenges."""

import threading

import pytest

from bulletproofspp_tpu.core import multiparty as jmp
from bulletproofspp_tpu.core.transcript import Transcript as JTranscript
from bulletproofspp_tpu_torch.core import ec, multiparty
from bulletproofspp_tpu_torch.core.fields import R
from bulletproofspp_tpu_torch.core.multiparty import ClientOracle, LocalChannel, run_dealer
from bulletproofspp_tpu_torch.core.transcript import Transcript


def test_dealer_aggregates_and_broadcasts():
    nparties = 3
    chans = [LocalChannel() for _ in range(nparties)]
    # party i commits share s_i * G; dealer must see (sum s_i) * G
    shares = [[7, 11], [13, 17], [19, 23]]

    def party(i):
        oracle = ClientOracle(chans[i])
        pts = [ec.scalar_mul(s, ec.G) for s in shares[i]]
        challenge = oracle.oracle(pts, 1)
        # every party must receive the same challenge
        results[i] = challenge
        oracle.done([s * challenge[0] % R for s in shares[i]])

    results = [None] * nparties
    threads = [threading.Thread(target=party, args=(i,)) for i in range(nparties)]
    for t in threads:
        t.start()

    summed, rounds, challenges = run_dealer(chans, Transcript(None))
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()

    assert results[0] == results[1] == results[2]
    # aggregate commitments are the group sums of the shares
    tot = [sum(col) for col in zip(*shares)]
    assert rounds[0] == [ec.scalar_mul(t, ec.G) for t in tot]
    # dealer-side transcript equals a single-prover transcript on the sums
    assert results[0] == Transcript(None).oracle(rounds[0], 1)
    # final openings combine additively
    e = results[0][0]
    assert summed == [t * e % R for t in tot]


def test_dealer_over_sockets():
    """The same protocol over the TCP transport."""
    from bulletproofspp_tpu_torch.core.multiparty import (
        SocketChannel,
        make_dealer_listener,
        run_dealer_on_listener,
    )

    nparties = 2
    shares = [[3, 5], [8, 21]]
    listener, port = make_dealer_listener()
    results = [None] * nparties

    def party(i):
        ch = SocketChannel.connect("127.0.0.1", port)
        try:
            oracle = ClientOracle(ch)
            pts = [ec.scalar_mul(s, ec.G) for s in shares[i]]
            challenge = oracle.oracle(pts, 1)
            results[i] = challenge
            oracle.done([s * challenge[0] % R for s in shares[i]])
        finally:
            ch.close()

    threads = [threading.Thread(target=party, args=(i,)) for i in range(nparties)]
    for t in threads:
        t.start()
    try:
        summed, rounds, challenges = run_dealer_on_listener(listener, Transcript(None), nparties)
    finally:
        listener.close()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()

    assert results[0] == results[1]
    tot = [sum(col) for col in zip(*shares)]
    assert rounds[0] == [ec.scalar_mul(t, ec.G) for t in tot]
    e = results[0][0]
    assert summed == [t * e % R for t in tot]


def test_aggregated_opening_demo():
    """The aggregated-opening proof of knowledge (the CLI's mp-demo): the
    dealer's Schnorr check on the aggregates accepts, and rejects when one
    party lies in its final response share."""
    from bulletproofspp_tpu_torch.core.multiparty import (
        dealer_aggregated_opening,
        run_party_share,
    )

    nparties = 3
    for tamper in (False, True):
        chans = [LocalChannel() for _ in range(nparties)]
        threads = []
        for i in range(nparties):
            def party(i=i):
                if tamper and i == 1:
                    # dishonest response share: the honest protocol with the
                    # final opening shifted by 1
                    ch = chans[i]
                    orig_send = ch.send

                    def send(msg):
                        if msg[0] == "done":
                            msg = (msg[0], [(int(msg[1][0]) + 1) % R] + list(msg[1][1:])) + msg[2:]
                        orig_send(msg)

                    ch.send = send
                run_party_share(chans[i], value=100 + i, blind=7 * i + 1, seed=bytes([i]))

            threads.append(threading.Thread(target=party))
        for t in threads:
            t.start()
        ok, c_agg = dealer_aggregated_opening(chans, Transcript(None))
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert ok == (not tamper)
        assert c_agg is not None


def _one_shot_dealer(msg):
    """The dealer against one scripted party message: the ValueError it
    raised, or None."""
    ch = LocalChannel()
    ch.send(msg)
    try:
        run_dealer([ch], Transcript(None))
    except ValueError as exc:
        return exc
    return None


def test_dealer_rejects_unreasonable_challenge_count():
    """k drives oracle work: a party-supplied huge k is a dealer DoS."""
    exc = _one_shot_dealer(("commit", [ec.G], 1 << 32))
    assert exc is not None and "challenge count" in str(exc)


def test_dealer_rejects_off_curve_point():
    exc = _one_shot_dealer(("commit", [(5, 7)], 1))
    assert exc is not None and "off-curve" in str(exc)


def _script(mod, messages):
    """One LocalChannel of package ``mod`` a party, each holding that
    party's messages, queued as a party would send them."""
    chans = []
    for party in messages:
        ch = mod.LocalChannel()
        for msg in party:
            ch.send(msg)
        chans.append(ch)
    return chans


def test_run_dealer_equals_the_jax_package_on_the_same_messages():
    """Three parties, two commit rounds (k = 3, then 1; an identity among a
    party's points) and their openings: the port's run_dealer returns the
    JAX package's aggregates, rounds and challenges, and broadcasts the
    same challenges to every party."""
    pts = [[ec.scalar_mul(7 * i + j + 1, ec.G) for j in range(3)] for i in range(3)]
    pts[1][2] = None
    messages = [
        [("commit", pts[i], 3), ("commit", [ec.scalar_mul(11 + i, ec.G)], 1),
         ("done", [R - 1 - i, 5 * i, 2**200 + i], 0)]
        for i in range(3)
    ]
    port_chans = _script(multiparty, messages)
    jax_chans = _script(jmp, messages)
    got = run_dealer(port_chans, Transcript(None))
    want = jmp.run_dealer(jax_chans, JTranscript(None))
    assert got == want
    summed, rounds, challenges = got
    assert [len(r) for r in rounds] == [3, 1] and [len(c) for c in challenges] == [3, 1]
    assert rounds[0][2] == ec.add(pts[0][2], pts[2][2])
    assert summed == [(3 * R - 6) % R, 15, (3 * 2**200 + 3) % R]
    for ch in port_chans:
        assert [ch.recv(), ch.recv()] == challenges


def test_run_dealer_rejects_mixed_rounds_like_the_jax_package():
    messages = [[("commit", [ec.G], 1)], [("done", [1], 0)]]
    with pytest.raises(ValueError, match="out of sync"):
        run_dealer(_script(multiparty, messages), Transcript(None))
    with pytest.raises(ValueError, match="out of sync"):
        jmp.run_dealer(_script(jmp, messages), JTranscript(None))
