"""Fiat-Shamir transcript — bit-exact with the reference CLI.

The reference hashes the *Haskell-show rendering* of affine coordinates:
each oracle scalar is ``hash (show n <> show (length ps) <> foldMap coords ps)``
where ``coords (A x y) = show x <> show y`` and ``show`` on the generic
``Prime p`` field renders as ``"P <decimal>"`` (derived Show of
``newtype Prime p = P Natural`` in galois-field-1.0.1)
(reference: app/Main.hs:75-80).

Scalars decode from SHA-256 digests via the ``Binary (Prime p)`` instance:
four 64-bit words, *little-endian word order* but big-endian bytes within
each word, reduced mod the field characteristic
(reference: src/Encoding.hs:75-86, app/Main.hs:64-65).

The transcript *prepends* each new commitment batch to the running list
and re-hashes the entire list (reference: src/ZKP.hs:96-101).
"""

from __future__ import annotations

import hashlib

from .fields import Q, R


def decode_scalar(digest: bytes, p: int) -> int:
    """Binary get for Prime p: a0 + a1*2^64 + a2*2^128 + a3*2^192 (mod p),
    each a_i read as a big-endian Word64 (reference: src/Encoding.hs:76-79)."""
    assert len(digest) == 32
    a0 = int.from_bytes(digest[0:8], "big")
    a1 = int.from_bytes(digest[8:16], "big")
    a2 = int.from_bytes(digest[16:24], "big")
    a3 = int.from_bytes(digest[24:32], "big")
    return (a0 + (a1 << 64) + (a2 << 128) + (a3 << 192)) % p


def encode_scalar(v: int) -> bytes:
    """Binary put for Prime p (reference: src/Encoding.hs:80-86)."""
    return b"".join(((v >> (64 * i)) & ((1 << 64) - 1)).to_bytes(8, "big") for i in range(4))


def _show_field(v: int) -> bytes:
    # galois-field derived Show of `P Natural`
    return b"P " + str(v).encode()


def _coords(pt) -> bytes:
    # reference: app/Main.hs:78-79; the reference crashes on the identity
    # (partial pattern match on `A x y`), which cannot occur for blinded
    # commitments.  We raise to surface the same impossibility.
    if pt is None:
        raise ValueError("transcript cannot absorb the identity point")
    x, y = pt
    return _show_field(x) + _show_field(y)


def sha_oracle(points, n: int) -> int:
    """n-th oracle scalar (n starts at 1) over the full transcript list."""
    msg = str(n).encode() + str(len(points)).encode() + b"".join(_coords(p) for p in points)
    return decode_scalar(hashlib.sha256(msg).digest(), R)


def hash_to_scalar(prefix: bytes, suffix: bytes, p: int = R) -> int:
    """hashToScalar (reference: app/Main.hs:83-84)."""
    return decode_scalar(hashlib.sha256(prefix + suffix).digest(), p)


def get_points(seed: bytes):
    """Infinite deterministic basis-point stream from a seed string.

    (reference: app/Main.hs:68-72 ``getPoints``): x = H(seed <> show n)
    decoded mod Q; skip if x^3+7 is a non-residue; y is the principal root.
    """
    from . import ec

    n = 0
    while True:
        x = decode_scalar(hashlib.sha256(seed + str(n).encode()).digest(), Q)
        pt = ec.point_x(x)
        if pt is not None:
            yield pt
        n += 1


def take_points(seed: bytes, k: int):
    gen = get_points(seed)
    return [next(gen) for _ in range(k)]


def default_blinds(random_seed: bytes):
    """Infinite stream of input blinding values (reference: app/Main.hs:86-87,276):
    blind_i = H("Blinding " <> seed <> show i), i = 1.."""
    i = 1
    while True:
        yield hash_to_scalar(b"Blinding " + random_seed, str(i).encode())
        i += 1


class Transcript:
    """ZKPT equivalent: running prepended commitment list + PRG counter.

    (reference: src/ZKP.hs:68-101).  ``random`` is the prover's blinding
    source h(counter) = H(seed <> show counter), counter from 0
    (reference: app/Main.hs:177).  The verifier constructs with
    ``random_seed=None`` and must never call ``random``.
    """

    def __init__(self, random_seed: bytes | None):
        self._points: list = []
        self._counter = 0
        self._seed = random_seed

    def random(self) -> int:
        if self._seed is None:
            raise RuntimeError("No random in verifier")
        v = hash_to_scalar(self._seed, str(self._counter).encode())
        self._counter += 1
        return v

    def randoms(self, k: int) -> list:
        return [self.random() for _ in range(k)]

    def oracle(self, new_points, k: int = 1) -> list:
        """Prepend new commitments, return the first k oracle scalars."""
        self._points = list(new_points) + self._points
        return [sha_oracle(self._points, n) for n in range(1, k + 1)]
