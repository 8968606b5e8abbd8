"""Binary proof / commitment serialization (reference: src/Encoding.hs).

Wire format of a proof (reference: src/RangeProof.hs:60-66):
  [witness scalars: norm openings then linear openings, each 4 x Word64
   little-endian limb order / big-endian bytes]
  ++ [points: sign-bit bytes for ALL points, then x-coordinates]
where the points are [range-proof commitments] ++ [L/R response pairs].
The input value commitments are written to a separate commitments file.
"""

from __future__ import annotations

from .fields import Q
from .transcript import decode_scalar, encode_scalar
from . import ec


def bit_pack(bits) -> bytes:
    """LSB-first within each byte (reference: src/Encoding.hs:107-111)."""
    out = bytearray()
    for i in range(0, len(bits), 8):
        w = 0
        for j, b in enumerate(bits[i : i + 8]):
            if b:
                w |= 1 << j
        out.append(w)
    return bytes(out)


def bit_unpack(data: bytes) -> list:
    return [bool((w >> j) & 1) for w in data for j in range(8)]


def x_and_sign(pt):
    """(x, y > p-y) (reference: src/Encoding.hs:113-118)."""
    x, y = pt
    return x, y > (ec.P - y) % ec.P


def from_x_with_sign(x: int, sign: bool):
    """Decompress; flip to the root matching the sign bit
    (reference: src/Encoding.hs:97-103)."""
    pt = ec.point_x(x)
    if pt is None:
        return None
    px, py = pt
    if (py > (ec.P - py) % ec.P) != sign:
        return (px, (ec.P - py) % ec.P)
    return pt


def encode_commitments(points) -> bytes:
    xs, signs = zip(*[x_and_sign(p) for p in points]) if points else ((), ())
    return bit_pack(list(signs)) + b"".join(encode_scalar(x) for x in xs)


def parse_commitments(n: int, data: bytes, offset: int = 0):
    """Byte-level parse WITHOUT point decompression: returns
    ([(x, sign)], new_offset) or None on truncation.  Lets batch decoders
    collect every x across many proofs into ONE device sqrt call."""
    n_sign_bytes = (n + 7) // 8
    if len(data) < offset + n_sign_bytes + 32 * n:
        return None
    signs = bit_unpack(data[offset : offset + n_sign_bytes])
    offset += n_sign_bytes
    xs = []
    for i in range(n):
        # The reference decodes x through `toP`, which silently reduces mod Q
        # (reference: src/Encoding.hs:77-79).
        xs.append((decode_scalar(data[offset : offset + 32], Q), signs[i]))
        offset += 32
    return xs, offset


def decode_commitments(n: int, data: bytes, offset: int = 0):
    """Returns (points, new_offset) or None on failure."""
    res = parse_commitments(n, data, offset)
    if res is None:
        return None
    xs, offset = res
    pts = []
    for x, sign in xs:
        pt = from_x_with_sign(x, sign)
        if pt is None:
            return None
        pts.append(pt)
    return pts, offset


def encode_scalars_points(scalars, points) -> bytes:
    return b"".join(encode_scalar(int(s)) for s in scalars) + encode_commitments(points)


def decode_scalars_points(s_n: int, p_n: int, data: bytes):
    if len(data) < 32 * s_n:
        return None
    scalars = [decode_scalar(data[32 * i : 32 * i + 32], ec.R) for i in range(s_n)]
    res = decode_commitments(p_n, data, 32 * s_n)
    if res is None:
        return None
    pts, off = res
    return scalars, pts
