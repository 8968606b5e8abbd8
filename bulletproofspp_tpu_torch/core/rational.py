"""Rational scalar reduction via extended-GCD (host, exact integers).

Used every collapse round to fold basis pairs with half-size scalars
(reference: src/Commitment.hs:242-255 ``rationalReduceScalar``).  The CLI
uses the generic ``Prime p`` instance, so the transcript-relevant math is
plain-integer egcd (not the Eisenstein variant).

The result (a, b) satisfies a * b^{-1} = x (mod p) with a^2 <= 2p, and is
*exactly* the pair the reference computes (it affects proof bytes through
the basis normalizers).
"""

from __future__ import annotations


def signed_lift(x: int, p: int) -> int:
    """n if n <= p-n else -(p-n) (reference: src/Commitment.hs:276-279)."""
    n = x % p
    return -(p - n) if n > p - n else n


def rational_reduce(x: int, p: int) -> tuple[int, int]:
    """First egcd convergent (a, b) of x with |a|^2 <= 2p.

    egcd starts from (p, 0), (signed_lift x, 1) and yields the second pair
    first; quotients use Haskell ``quot`` = truncation toward zero
    (reference: src/Commitment.hs:242-255).
    """
    r0, s0 = p, 0
    r1, s1 = signed_lift(x, p), 1
    # the stream yields (r1, s1) first
    while r1 * r1 > 2 * p:
        # Haskell `quot` truncates toward zero
        q = abs(r0) // abs(r1)
        if (r0 < 0) != (r1 < 0):
            q = -q
        r0, r1 = r1, r0 - q * r1
        s0, s1 = s1, s0 - q * s1
    return r1, s1
