"""Multiparty-prover combinators: dealer / client oracle.

The port's copy of ``bulletproofspp_tpu/core/multiparty.py``; the logic is
the same, line for line.  The reference ships exactly two
transport-parametric stubs and never wires them to the CLI (reference:
src/ZKP.hs:106-131): a client that ships its commitment batch to a dealer
and receives the oracle output (``multiPartyClientOracle``,
ZKP.hs:114-118), and a dealer that sums the per-party commitment vectors
elementwise in the group, runs the REAL oracle on the aggregate, and
broadcasts the result until parties stop (``multiPartyDealer``,
ZKP.hs:124-131).

This module has the same contract and the same status (aggregation
semantics + transport harness; the full multiparty range prover built on
it is ``core/mp_prove.py``).  The transport is any object with
``send``/``recv``; ``LocalChannel`` gives in-process queues so the
combinators are testable without a cluster, and ``SocketChannel`` /
``SocketDealerChannel`` carry the same messages over TCP between
processes.  The dealer's reduction is an exact host-integer group sum of
affine points: a party's commitments come back from its engine as affine
tuples / None, whatever the engine, before they are sent.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field

from . import ec


@dataclass
class LocalChannel:
    """In-process duplex channel (client endpoint <-> dealer endpoint)."""

    to_dealer: queue.Queue = field(default_factory=queue.Queue)
    to_client: queue.Queue = field(default_factory=queue.Queue)

    # client side
    def send(self, msg):
        self.to_dealer.put(msg)

    def recv(self):
        return self.to_client.get()

    # dealer side
    def dealer_send(self, msg):
        self.to_client.put(msg)

    def dealer_recv(self):
        return self.to_dealer.get()


# ---------------------------------------------------------------------------
# Socket transport between processes (reference: ZKP.hs:110-111 notes the
# combinators are transport-parametric "Chan, socket").  Wire format is
# length-prefixed JSON (arbitrary-precision ints are native in Python
# JSON; no pickle, so a malicious peer cannot execute code).
# ---------------------------------------------------------------------------

import json as _json
import socket as _socket
import struct as _struct


def _send_msg(sock, obj):
    data = _json.dumps(obj).encode()
    sock.sendall(_struct.pack(">Q", len(data)) + data)


def _recv_msg(sock):
    hdr = _recv_exact(sock, 8)
    (n,) = _struct.unpack(">Q", hdr)
    if n > 1 << 30:
        raise ValueError("oversized multiparty message")
    return _json.loads(_recv_exact(sock, n).decode())


def _recv_exact(sock, n):
    # list+join, not buf += chunk: messages may be large and repeated
    # full-buffer copies are quadratic
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _enc_pts(pts):
    return [None if p is None else [int(p[0]), int(p[1])] for p in pts]


def _dec_pts(pts):
    return [None if p is None else (int(p[0]), int(p[1])) for p in pts]


class SocketChannel:
    """Client endpoint over TCP: same send/recv contract as LocalChannel."""

    def __init__(self, sock):
        self.sock = sock

    @classmethod
    def connect(cls, host: str, port: int):
        return cls(_socket.create_connection((host, port)))

    def send(self, msg):
        kind = msg[0]
        if kind == "commit":
            _send_msg(self.sock, {"t": "commit", "pts": _enc_pts(msg[1]), "k": msg[2]})
        else:
            _send_msg(self.sock, {"t": "done", "op": [int(v) for v in msg[1]]})

    def recv(self):
        return [int(v) for v in _recv_msg(self.sock)]

    def close(self):
        self.sock.close()


class SocketDealerChannel:
    """Dealer-side endpoint for one connected party."""

    def __init__(self, sock):
        self.sock = sock

    def dealer_recv(self):
        m = _recv_msg(self.sock)
        if m["t"] == "commit":
            return ("commit", _dec_pts(m["pts"]), int(m["k"]))
        return ("done", [int(v) for v in m["op"]], 0)

    def dealer_send(self, msg):
        _send_msg(self.sock, [int(v) for v in msg])

    def close(self):
        self.sock.close()


def make_dealer_listener(host: str = "127.0.0.1", port: int = 0):
    """Bind a dealer listener; returns (socket, bound_port) so the port
    can be communicated to parties before accepting."""
    s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
    s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
    s.bind((host, port))
    s.listen()
    return s, s.getsockname()[1]


def run_dealer_on_listener(listener, transcript, n_parties: int):
    chans = []
    try:
        for _ in range(n_parties):
            sock, _ = listener.accept()
            chans.append(SocketDealerChannel(sock))
        return run_dealer(chans, transcript)
    finally:
        for c in chans:
            c.close()


class ClientOracle:
    """Client-side oracle: ships commitments, receives challenge scalars
    (reference: multiPartyClientOracle, ZKP.hs:114-118).  Drop-in for the
    ``oracle`` method of core.transcript.Transcript."""

    def __init__(self, channel):
        self.channel = channel

    def oracle(self, new_points, k: int = 1):
        self.channel.send(("commit", list(new_points), k))
        return self.channel.recv()

    def done(self, openings):
        """Final message: the party's additive share of the openings."""
        self.channel.send(("done", openings, 0))


def run_dealer(channels, transcript):
    """Dealer loop (reference: multiPartyDealer, ZKP.hs:124-131):

    per round, receive one commitment batch from every party, sum the
    vectors elementwise in the group (zipWith (^+^)), feed the aggregate
    to the real transcript oracle, and broadcast the challenges; when all
    parties send final openings, return their elementwise scalar sum, the
    aggregated commitment transcript, and the broadcast challenges.
    """
    rounds = []
    challenges = []
    while True:
        msgs = [ch.dealer_recv() for ch in channels]
        kinds = {m[0] for m in msgs}
        if kinds == {"done"}:
            n = len(msgs[0][1])
            if any(len(m[1]) != n for m in msgs):
                raise ValueError("parties returned differing opening lengths")
            # openings combine in the scalar field (the reference's
            # zipWith (^+^) is vector-space addition, ZKP.hs:129)
            from .fields import R

            summed = [sum(int(m[1][i]) for m in msgs) % R for i in range(n)]
            return summed, rounds, challenges
        if kinds != {"commit"}:
            raise ValueError("parties out of sync (mixed commit/done round)")
        n = len(msgs[0][1])
        k = msgs[0][2]
        if any(len(m[1]) != n or m[2] != k for m in msgs):
            raise ValueError("parties sent differing batch shapes")
        # bound party-controlled inputs: k drives oracle work (a huge k
        # is a dealer DoS) and off-curve points would corrupt the
        # aggregate — the transport already hardens against malicious
        # peers (no pickle, size caps), so validate here too
        if not (0 <= int(k) <= 256):
            raise ValueError("unreasonable challenge count from party")
        for _, pts, _ in msgs:
            for p in pts:
                if p is not None and not ec.is_on_curve((int(p[0]), int(p[1]))):
                    raise ValueError("party sent an off-curve point")
        agg = [None] * n
        for _, pts, _ in msgs:
            agg = [ec.add(a, p) for a, p in zip(agg, pts)]
        rounds.append(agg)
        out = transcript.oracle(agg, k)
        challenges.append(list(out))
        for ch in channels:
            ch.dealer_send(out)


# ---------------------------------------------------------------------------
# Aggregated-opening proof of knowledge: the executable end-to-end demo
# of the dealer/client contract (which the reference defines but never
# wires to anything, ZKP.hs:106-131 + app/Main.hs).  N parties each hold
# a secret Pedersen opening (v_i, r_i) of C_i = v_i*B0 + r_i*B1; the
# dealer aggregates C = sum C_i and A = sum A_i (A_i the Schnorr nonce
# commitments), broadcasts the Fiat-Shamir challenge e, sums the
# parties' response shares, and checks  s*B0 + u*B1 == A + e*C  — a
# proof of knowledge of the opening of the AGGREGATE commitment.
#
# Scope matches the reference's dealer semantics: honest-parties
# additive aggregation (no rogue-key hardening — parties are cooperating
# provers of a joint statement, not mutually adversarial signers); a
# full multiparty Bulletproofs++ prover additionally needs MPC
# cross-terms, which the reference does not implement either.
# ---------------------------------------------------------------------------

MP_BASIS_SEED = b"bppp multiparty demo basis"


def mp_basis():
    from .transcript import take_points

    return take_points(MP_BASIS_SEED, 2)


def run_party_share(channel, value: int, blind: int, seed: bytes):
    """One party's client side: commit (C_i, A_i), receive e, respond
    with the additive response share (s_i, u_i).

    The Schnorr nonces MUST be unpredictable: a party's (s_i, u_i)
    response share reveals (value, blind) to anyone who can compute its
    nonce, and a nonce reused across sessions with different challenges
    leaks them algebraically.  Fresh per-session entropy is therefore
    mixed in unconditionally — ``seed`` only adds caller-side
    domain separation, it need not be secret."""
    import os

    from .fields import R
    from .transcript import hash_to_scalar

    b0, b1 = mp_basis()
    sess = seed + os.urandom(32)
    k = hash_to_scalar(sess, b"mp nonce k")
    t = hash_to_scalar(sess, b"mp nonce t")
    ci = ec.add(ec.scalar_mul(value % R, b0), ec.scalar_mul(blind % R, b1))
    ai = ec.add(ec.scalar_mul(k, b0), ec.scalar_mul(t, b1))
    oracle = ClientOracle(channel)
    e = oracle.oracle([ci, ai], 1)[0]
    oracle.done([(k + e * value) % R, (t + e * blind) % R])


def dealer_aggregated_opening(channels, transcript):
    """Dealer side: aggregate, challenge, sum responses, verify.

    Returns (ok, C_agg): ok is the Schnorr check
    s*B0 + u*B1 == A + e*C on the aggregates."""
    b0, b1 = mp_basis()
    summed, rounds, challenges = run_dealer(channels, transcript)
    if len(rounds) != 1 or len(rounds[0]) != 2 or len(summed) != 2:
        raise ValueError("aggregated-opening demo expects one (C, A) round")
    c_agg, a_agg = rounds[0]
    e = challenges[0][0]
    s, u = summed
    lhs = ec.add(ec.scalar_mul(s, b0), ec.scalar_mul(u, b1))
    rhs = ec.add(a_agg, ec.scalar_mul(e, c_agg))
    return lhs == rhs, c_agg
