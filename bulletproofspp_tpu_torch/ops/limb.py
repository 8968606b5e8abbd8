"""secp256k1 base field Fq on (16, ...) int64 planes of 16-bit limbs.

The port's plain-PyTorch field: the same contract at every public
function as ``bulletproofspp_tpu.ops.limb`` (element batches are arrays of
shape ``(16, *batch)``, limb axis leading, limb i worth 2^(16 i)), but the
planes are ``torch.int64``: PyTorch on the CPU has no uint32 ``+`` or
``>>``, and 64-bit lanes leave room for lazy reduction.  Everything runs
on CPU and CUDA tensors alike (only elementwise ops, sums and
``index_add_``), so ``ops.kernels`` can hold each CUDA kernel against it
on the card; ``inv`` and ``batch_inv`` alone launch a kernel on a CUDA
tensor (``fermat_inv`` and ``batch_inv_plain`` are their plain versions).

Forms (the bounds every function states are worst cases, derived below
by ``_wrap_passes`` on per-row bounds, not by hand):
  * strict: limbs < 2^16, value < 2^256 (not necessarily < p).  Every
    public function takes and returns strict planes; ``normalize`` gives
    the canonical value < p.
  * loose: limbs <= LOOSE_MAX (about 2^16 + 2^10), value any
    representative.  ``mul_loose`` returns it; ``tighten`` makes it strict.
  * ``mul_loose`` inputs: limbs < 2^24 (products < 2^48, so every column
    sum and both reduction folds stay < 2^62 in int64).

Reduction uses p = 2^256 - C, C = 2^32 + 977: a row at limb 16 + k
folds into rows k (times 977) and k + 2.  Exact carries resolve the
single-bit ripple with the packed-bit trick of the Pallas kernels
(``bulletproofspp_tpu/ops/pallas_field.py:_resolve_k``): one integer
addition over a word holding one bit per limb.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.fields import Q

NLIMB = 16
LBITS = 16
MASK = (1 << LBITS) - 1
C_LOW = 977
assert Q == (1 << 256) - ((1 << 32) + C_LOW)

DTYPE = torch.int64

# subtraction complement width: subtrahend limbs must be <= SUB_W
SUB_W = (1 << 23) - 1
MUL_IN_MAX = (1 << 24) - 1
# limb bound of the loose form; wrap passes settle at row 0 <= MASK + 977
LOOSE_MAX = MASK + 2 * C_LOW


# ---------------------------------------------------------------------------
# Host <-> limb conversion (numpy, exact Python ints)
# ---------------------------------------------------------------------------


def pack_ints(vals) -> np.ndarray:
    """list[int] (< 2^256) -> (16, n) uint32 limb array (the JAX package's
    host layout): one bytes join and one numpy view, no per-value array
    writes (the MSM packs 2^20 points at a time)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, NLIMB).T.astype(np.uint32)


def unpack_ints(arr) -> list:
    """(16, n) limb array (numpy or a strict torch plane) -> list[int]."""
    if isinstance(arr, torch.Tensor):
        arr = planes_to_numpy(arr)
    buf = np.ascontiguousarray(np.asarray(arr, np.uint32).astype("<u2").T).tobytes()
    return [int.from_bytes(buf[32 * j : 32 * j + 32], "little") for j in range(len(buf) // 32)]


def pack_int(v: int) -> np.ndarray:
    return pack_ints([v])[:, 0]


def planes_from_numpy(arr, device) -> torch.Tensor:
    """numpy integer array (limb planes, digits, signs) -> int64 tensor on
    ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.int64)).to(device)


def planes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Strict int64 limb planes (any device) -> numpy uint32."""
    return t.detach().cpu().numpy().astype(np.uint32)


def from_ints(vals, device) -> torch.Tensor:
    return planes_from_numpy(pack_ints(vals), device)


def const(v: int, like: torch.Tensor) -> torch.Tensor:
    """(16, 1, ..., 1) plane of the constant ``v``, broadcastable to ``like``."""
    return _const(v, like.device, like.dim())


@functools.cache
def _const(v: int, device, ndim: int) -> torch.Tensor:
    shape = (NLIMB,) + (1,) * (ndim - 1)
    return torch.tensor(pack_int(v).astype(np.int64), device=device).reshape(shape)


def zeros(batch, device) -> torch.Tensor:
    return torch.zeros((NLIMB, *batch), dtype=DTYPE, device=device)


def ones(batch, device) -> torch.Tensor:
    z = zeros(batch, device)
    z[0] = 1
    return z


# ---------------------------------------------------------------------------
# Carries
# ---------------------------------------------------------------------------


def _wrap_bounds(b):
    """Per-row worst-case bounds after one ``_wrap_pass``."""
    hi = [x >> LBITS for x in b]
    out = [min(x, MASK) for x in b]
    for i in range(1, NLIMB):
        out[i] += hi[i - 1]
    out[0] += C_LOW * hi[-1]
    out[2] += hi[-1]
    return out


@functools.cache
def _wrap_passes(bound: int, target: int) -> int:
    """Number of ``_wrap_pass`` calls that take 16 rows, each <= ``bound``,
    to rows all <= ``target``."""
    b = [bound] * NLIMB
    n = 0
    while max(b) > target:
        b = _wrap_bounds(b)
        n += 1
        assert n < 16, "carry bound does not converge"
    return n


def _wrap_pass(t):
    """One carry pass over 16 rows with the 2^256 overflow folded back in
    (2^256 = C mod p).  Same value mod p; limbs shrink toward 2^16."""
    hi = t >> LBITS
    out = t & MASK
    out[1:] += hi[:-1]
    out[0] += C_LOW * hi[-1]
    out[2] += hi[-1]
    return out


def _wrap(t, bound: int, target: int):
    for _ in range(_wrap_passes(bound, target)):
        t = _wrap_pass(t)
    return t


def _resolve(t):
    """Exact carry of K rows with limbs <= 2^17 - 2 (K <= 61):
    -> (r, cb): r strict K rows and cb in {0, 1} the carry out of the top,
    value(t) = value(r) + cb * 2^(16 K).

    The residual carries g = t >> 16 are single bits and g = 1 forces
    d = t & MASK < MASK, so no row both generates and propagates.  Pack
    g (shifted up one row) and the propagate bits into one integer per
    lane each; one addition then ripples every carry, and bit i of
    (s ^ v ^ u) | u is the carry into row i (pallas_field._resolve_k)."""
    K = t.shape[0]
    sh = torch.arange(K, device=t.device, dtype=DTYPE).reshape((K,) + (1,) * (t.dim() - 1))
    d = t & MASK
    u = ((t >> LBITS) << sh).sum(0) << 1
    v = ((d == MASK).to(DTYPE) << sh).sum(0)
    c = ((v + u) ^ v ^ u) | u
    r = (d + ((c.unsqueeze(0) >> sh) & 1)) & MASK
    return r, (c >> K) & 1


def _add_c(r, cb):
    """r + cb * C over 16 strict rows, cb in {0, 1}; limbs <= 2^16 + 976."""
    r = r.clone()
    r[0] += C_LOW * cb
    r[2] += cb
    return r


def tighten(t, bound: int = (1 << 62) - 1):
    """16 rows of nonnegative limbs <= ``bound`` (< 2^62) -> strict, same
    value mod p.  Wrap passes bring the limbs to <= 2^17 - 2; a resolve
    leaves value = r + cb * 2^256; adding cb * C may carry out once more
    (only when r >= 2^256 - C), and then the remainder is < C, so the
    third fold cannot carry."""
    t = _wrap(t, bound, (1 << 17) - 2)
    r, cb = _resolve(t)
    r, cb = _resolve(_add_c(r, cb))
    r, _ = _resolve(_add_c(r, cb))
    return r


def loosen(t, bound: int):
    """16 rows of limbs <= ``bound`` -> loose (limbs <= LOOSE_MAX)."""
    return _wrap(t, bound, LOOSE_MAX)


# ---------------------------------------------------------------------------
# Ring ops
# ---------------------------------------------------------------------------


@functools.cache
def _col_index(device) -> torch.Tensor:
    """Flattened (i, j) -> column i + j of the 16 x 16 outer product."""
    i = torch.arange(NLIMB).reshape(NLIMB, 1)
    return (i + i.T).reshape(-1).to(device)


def mul_loose(a, b):
    """a * b mod p for limbs <= MUL_IN_MAX -> loose.

    Outer product (< 2^48 per term), column sums (< 16 * 2^48 = 2^52),
    then the columns >= 16 fold into the low 16 rows lazily (column 30
    twice): rows < 979 * 2^52 + 977 * 2^48 < 2^62.  Wrap passes finish."""
    batch = a.shape[1:]
    prod = (a.unsqueeze(1) * b.unsqueeze(0)).reshape(NLIMB * NLIMB, *batch)
    cols = torch.zeros((2 * NLIMB, *batch), dtype=DTYPE, device=a.device)
    cols.index_add_(0, _col_index(a.device), prod)
    hi = cols[NLIMB:]  # columns 16..31 (31 is empty)
    t = cols[:NLIMB] + C_LOW * hi
    t[2:] += hi[:-2]
    top = hi[-2]  # column 30 landed at row 16
    t[0] += C_LOW * top
    t[2] += top
    return _wrap(t, (1 << 62) - 1, LOOSE_MAX)


def sub_raw(a, b):
    """a - b mod p without carrying: a + (SUB_W - b per limb) + KC, where
    KC = -(SUB_W * S16) mod p (S16 = sum of 2^(16 i)).  b limbs <= SUB_W;
    output limbs <= a + SUB_W + MASK."""
    return a + (SUB_W - b) + _kc(a)


_KC = (-(SUB_W * sum(1 << (16 * i) for i in range(NLIMB)))) % Q


def _kc(like):
    return const(_KC, like)


def add(a, b):
    """a + b mod p, strict in and out."""
    return tighten(a + b, 2 * MASK)


def sub(a, b):
    return tighten(sub_raw(a, b), MASK + SUB_W + MASK)


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    return tighten(mul_loose(a, b), LOOSE_MAX)


def sqr(a):
    return mul(a, a)


def mul_small(a, k: int):
    """a * k mod p for a small host constant 0 <= k < 2^15."""
    return tighten(a * k, MASK * k)


def normalize(a):
    """Strict -> canonical (< p): a >= p iff a + C carries out of 2^256,
    and then the low 256 bits of a + C are a - p."""
    r, cb = _resolve(_add_c(a, torch.ones_like(a[0])))
    return torch.where(cb.bool().unsqueeze(0), r, a)


def is_zero(a):
    """Boolean mask over the batch axes: a == 0 mod p (a strict)."""
    return (normalize(a) == 0).all(0)


def eq(a, b):
    return is_zero(sub(a, b))


def select(mask, a, b):
    """mask ? a : b per batch element (mask: batch-shaped bool)."""
    return torch.where(mask.unsqueeze(0), a, b)


def gt(a, b):
    """a > b as 256-bit integers (raw representatives; normalize first for
    a canonical comparison).  The highest differing limb decides, so with
    one bit per limb, a > b iff the word of rows where a_i > b_i exceeds the
    word of rows where a_i < b_i."""
    sh = torch.arange(NLIMB, device=a.device, dtype=DTYPE).reshape((NLIMB,) + (1,) * (a.dim() - 1))
    g = ((a > b).to(DTYPE) << sh).sum(0)
    s = ((a < b).to(DTYPE) << sh).sum(0)
    return g > s


def _pow(a, e: int):
    """a^e for a host exponent e >= 1: square-and-multiply over its bits
    below the top one, loose in between; strict out."""
    r = a.clone()
    for bit in bin(e)[3:]:
        r = mul_loose(r, r)
        if bit == "1":
            r = mul_loose(r, a)
    return tighten(r, LOOSE_MAX)


def sqrt_candidate(a):
    """a^((p+1)/4): the principal square root when a is a residue (p = 3
    mod 4; callers check r^2 == a)."""
    return _pow(a, (Q + 1) // 4)


# ---------------------------------------------------------------------------
# Inversion
# ---------------------------------------------------------------------------


def fermat_inv(a):
    """a^(p-2) = a^-1 mod p, strict; 0 and Q -> 0
    (``bulletproofspp_tpu/ops/limb.py:371``).  Plain PyTorch on any device:
    ``kernels.inv_plain`` normalizes it."""
    return _pow(a, Q - 2)


def inv(a):
    """a^-1 mod p over (16, *batch) strict planes, canonical; 0 and Q -> 0.
    The inv kernel on a CUDA tensor (``ops.kernels.inv``), its plain version
    (``kernels.inv_plain``, square-and-multiply) on a CPU tensor."""
    from . import kernels

    return kernels.inv(a)


def batch_inv(a, axis: int = -1):
    """a^-1 mod p of every element of (16, *batch) strict planes, canonical;
    zeros map to zero (``bulletproofspp_tpu/ops/limb.py:424``).  On a CPU
    tensor the JAX package's formulation along ``axis``
    (``batch_inv_plain``); on a CUDA tensor the inv kernel on every element:
    the inverse is unique, and Montgomery's trick saves products, not
    latency (its one inverse is the same chain of dependent products).
    Axis 0, the limb axis, is refused on either device."""
    axis = _batch_axis(a, axis)
    if a.device.type == "cpu":
        return batch_inv_plain(a, axis)
    from . import kernels

    return kernels.inv(a)


def _batch_axis(a, axis: int) -> int:
    """``axis`` of (16, *batch) planes as a non-negative batch axis."""
    axis %= a.dim()
    if axis == 0:
        raise ValueError("batch_inv: axis 0 is the limb axis")
    return axis


def _scan_mul(x, axis: int):
    """Inclusive prefix products along ``axis`` by a log-step scan: at step
    d each element from d on takes the product with the one d before it."""
    n = x.shape[axis]
    d = 1
    while d < n:
        x = torch.cat([x.narrow(axis, 0, d),
                       mul(x.narrow(axis, d, n - d), x.narrow(axis, 0, n - d))], axis)
        d *= 2
    return x


def batch_inv_plain(a, axis: int = -1):
    """Montgomery batch inversion with one Fermat inverse, as the JAX
    package formulates it (``limb.py:424-440``): zeros become 1; inclusive
    prefix and suffix products (``_scan_mul``); T = the inverse of the
    total; element i is exclusive prefix i x T x exclusive suffix i; zeros
    back to 0.  Canonical out; plain PyTorch on any device."""
    axis = _batch_axis(a, axis)
    n = a.shape[axis]
    if n == 0:
        return a.clone()
    zmask = is_zero(a)
    ax = select(zmask, ones(a.shape[1:], a.device), a)
    prefix = _scan_mul(ax, axis)
    suffix = _scan_mul(ax.flip(axis), axis).flip(axis)
    t = fermat_inv(prefix.narrow(axis, n - 1, 1)).expand_as(a)
    one = ones(prefix.narrow(axis, 0, 1).shape[1:], a.device)
    exc_pre = torch.cat([one, prefix.narrow(axis, 0, n - 1)], axis)
    exc_suf = torch.cat([suffix.narrow(axis, 1, n - 1), one], axis)
    out = mul(mul(exc_pre, t), exc_suf)
    return normalize(select(zmask, torch.zeros_like(a), out))
