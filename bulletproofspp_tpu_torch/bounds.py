"""The least time an H100 could take for each kernel's work: its bound.

A kernel's bound is the larger of two times:

  * bytes: each input the function needs read once and each output
    written once, over the card's memory rate (3.35 TB/s, H100 SXM data
    sheet).  Limb planes are int64: 128 B a field element, 384 B a point;
    digits are uint8 planes, |d| and the sign: 2 B a (row, lane).
    Where the reads depend on the data (digit selection), the count is of
    what this run's digits select: each lane's distinct table entries
    (for select_reduce X, Y and Z of each distinct nonzero |d|, its -Y
    made by negation).
  * operations: the 32-bit integer multiplies of ``csrc/field.cuh`` and
    ``csrc/curve.cuh`` that the work needs, over the card's rate for them:
    132 SMs x 64 a clock (the CUDA C++ Programming Guide's throughput of
    32-bit integer multiply and multiply-add for compute capability 9.0) x
    the SM clock that ``nvidia-smi`` reads as ``clocks.max.sm``.  A
    32 x 32 -> 64-bit product counts as two (its low and high words).  The
    carries, additions and loads are not counted, so the operations bound
    is low; the card's int32 multiply rate is the one peak this integer
    work has (the tensor cores take no 32-bit integers).

Counts per function, from the sources: ``fe_mul`` 64 word products of
the schoolbook, 8 of the 977 H fold and 1 of ``fe_fold``: 146 multiplies;
``fe_sqr`` 36 word products, the 977 H fold of 8 64-bit columns (3
multiplies each) and 1 of ``fe_fold``: 98; ``fe_mul_small`` 9 products:
18; ``fe_add`` one ``c * 977``: 2; ``fe_sub`` two ``o * 977``: 2.
``pt_add`` is 12 ``fe_mul``, 3 ``fe_mul_small``, 12
``fe_add`` and 5 ``fe_sub``; ``pt_dbl`` 8, 3, 3 and 1.

Neither limit sees latency.  A kernel whose work is a chain of dependent
point operations (``tail_horner``, ``horner``, ``fold``) or whose blocks
each wait on one (``select_reduce_fused``) sits far above both bounds, so
each such kernel also has the length of its longest dependent chain
(``*_chain``): in point operations, and in field-product rounds, a round
being one product's latency.  One thread runs an addition's 12 products
one after another; the warp-cooperative operations of
``csrc/curve_warp.cuh`` run an addition's or a doubling's in 2 rounds.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
SMS = 132
IMAD_PER_CLOCK_PER_SM = 64

FE_BYTES = 16 * 8
PT_BYTES = 3 * FE_BYTES
DIGIT_BYTES = 2  # |d| and the sign of one (row, lane), a byte each
FE_CANON = 0  # fe_canon: one carry chain of additions and a select, no multiply
FE_MUL = 2 * (64 + 8 + 1)
FE_MUL_SMALL = 2 * (8 + 1)
FE_ADD = 2
FE_SUB = 2
PT_ADD = 12 * FE_MUL + 3 * FE_MUL_SMALL + 12 * FE_ADD + 5 * FE_SUB
PT_DBL = 8 * FE_MUL + 3 * FE_MUL_SMALL + 3 * FE_ADD + 1 * FE_SUB
ADD_PRODUCTS = 12  # field products of pt_add

# decompress's square root a^((p+1)/4) as an addition chain (libsecp256k1's
# secp256k1_fe_sqrt; csrc/decompress.cu: fe_sqrt_candidate runs it): from r
# = a, each step (s, k) squares r s times, then multiplies it by a^(2^k - 1)
# (k = 0: no product), a value an earlier step made (the chain builds a^(2^k
# - 1) for k = 1, 2, 3, 6, 9, 11, 22, 44, 88, 176, 220, 223).  (p+1)/4 in
# binary is three blocks of ones, of lengths 2, 22 and 223.
SQRT_CHAIN = ((1, 1), (1, 1), (3, 3), (3, 3), (2, 2), (11, 11), (22, 22), (44, 44), (88, 88),
              (44, 44), (3, 3), (23, 22), (6, 2), (2, 0))
SQRT_SQUARINGS = sum(s for s, _ in SQRT_CHAIN)  # 253
SQRT_PRODUCTS = sum(1 for _, k in SQRT_CHAIN if k)  # 13

FE_SQR = 2 * 36 + 3 * 8 + 2
# decompress: x^2 and x^3 + 7, the square-root chain, r^2 and the negation
DECOMPRESS = (SQRT_SQUARINGS + 2) * FE_SQR + (SQRT_PRODUCTS + 1) * FE_MUL + FE_ADD + FE_SUB


def decompress_chain() -> int:
    """decompress's chain, one thread a lane: its dependent field products
    (x^2, x^3, the square-root chain, r^2)."""
    return 2 + SQRT_SQUARINGS + SQRT_PRODUCTS + 1


# the inverse by safegcd divsteps (csrc/field.cuh: fe_inv_divsteps,
# libsecp256k1's secp256k1_modinv32): DIVSTEP_BATCHES batches of
# DIVSTEPS_A_BATCH divsteps (600; 590 suffice for 256 bits), each batch then
# applying its 2x2 matrix to (d, e) and (f, g).  The divsteps multiply
# nothing (adds, logic and shifts on one word); a batch's updates take 4 x 9
# products of a matrix entry and a limb for each pair (32 x 32 -> 64: two
# multiplies each), for (d, e) also md and me times p's limb 0 (-977; its
# limbs 1 and 8, -4 and 2^16, are shifts), and the low words of p^-1 mod
# 2^30 times cd and ce (one multiply each).
DIVSTEP_BATCHES = 20
DIVSTEPS_A_BATCH = 30
DIVSTEP_BATCH = 2 * (2 * 4 * 9 + 2) + 2  # 150
INV = DIVSTEP_BATCHES * DIVSTEP_BATCH


def inv_chain() -> int:
    """inv's chain, one thread a lane: its dependent divstep batches (30
    divsteps, then the matrix updates, each)."""
    return DIVSTEP_BATCHES


def to_affine_chain() -> int:
    """to_affine's chain: the inverse of z's batches (then x z^-1, y z^-1
    beside it: one product)."""
    return inv_chain()


# multiplies per chain step, by phase (tools.cu: chain_step)
CHAIN_STEP = {
    "padd": PT_ADD,
    "mul_w16": 2 * (64 + 8),
    "mul_f16": FE_MUL,
    "mul_small": FE_MUL_SMALL,
    "add": FE_ADD,
    "add_s17": FE_ADD,
    "sub": FE_SUB,
    "sub_raw2": FE_ADD + FE_SUB,
    "carry_full": 2 * FE_ADD,
    "prod_form": 2 * 64,
}


def card() -> dict:
    """The card's name, power limit and maximum SM clock from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power, mhz = (v.strip() for v in out.split(","))
    return {"name": name, "power_limit_w": float(power), "sm_clock_max_mhz": float(mhz)}


def int_mul_rate(sm_mhz: float) -> float:
    """32-bit integer multiplies a second over the whole card."""
    return SMS * IMAD_PER_CLOCK_PER_SM * sm_mhz * 1e6


def bound(work, sm_mhz: float):
    """(multiplies, bytes) -> (bound ms, "bytes" or "operations")."""
    ops, nbytes = work
    t_ops = ops / int_mul_rate(sm_mhz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def bound_sum(works, sm_mhz: float):
    """The bound of launches that run one after another, each (multiplies,
    bytes): the sum of their bounds, named by the limit that gives the
    larger part of it."""
    parts = {"bytes": 0.0, "operations": 0.0}
    for work in works:
        ms, by = bound(work, sm_mhz)
        parts[by] += ms
    return sum(parts.values()), max(parts, key=parts.get)


def _distinct(idx, values: int) -> int:
    """Sum over (MSM, lane) of the distinct values that ``idx`` (B, rows,
    L) takes over its rows."""
    return int(sum(int((idx == e).any(1).sum()) for e in range(values)))


def _selected_bytes(absd, sgn) -> int:
    """Table entries the digits select, each (lane, entry) read once: X and
    Z by |d|, Y by |d| + 9 s."""
    return (2 * _distinct(absd, 9) + _distinct(absd + 9 * sgn, 18)) * FE_BYTES


# --- work of each kernel: (32-bit multiplies, bytes) -------------------------


def padd(n: int):
    return n * PT_ADD, n * 3 * PT_BYTES


def horner(batch: int, rows: int, canonical: bool = False):
    """``canonical``: the last warp's 3 ``fe_canon`` an MSM (no multiply);
    the same bytes out (three canonical planes)."""
    ops = batch * rows * (4 * PT_DBL + PT_ADD) + (3 * batch * FE_CANON if canonical else 0)
    return ops, (batch * rows + batch) * PT_BYTES


def reduce_block(w: int, factor: int):
    return (w // factor) * (factor - 1) * PT_ADD, (w + w // factor) * PT_BYTES


def reduce_block_tables(absd, sgn, factor: int):
    """reduce_block whose first level selects from the flat tables (msm's
    route from 256 to 1,023 lanes): its additions over the B rows L points
    the (B, rows, L) digits select; the table entries they select
    (``_selected_bytes``, as ``reduce_lanes``) and the digits in, the
    partials out."""
    w = absd.numel()
    return ((w // factor) * (factor - 1) * PT_ADD,
            _selected_bytes(absd, sgn) + w * DIGIT_BYTES + (w // factor) * PT_BYTES)


def reduce_block_chain(factor: int, narrow: bool):
    """(point operations, product rounds) of reduce_block's chain, an output
    lane's: F - 1 additions of 12 products one after another on one thread
    (wide), or the log2 F levels of its halving tree at 2 rounds an
    addition (narrow)."""
    if narrow:
        levels = factor.bit_length() - 1
        return levels, 2 * levels
    return factor - 1, ADD_PRODUCTS * (factor - 1)


def tail_horner(batch: int, rows: int, canonical: bool = False):
    ops = batch * rows * (127 * PT_ADD + 4 * PT_DBL + PT_ADD)
    ops += 3 * batch * FE_CANON if canonical else 0
    return ops, (batch * rows * 128 + batch) * PT_BYTES


def tail_horner_tables(absd, sgn, canonical: bool = False):
    """tail_horner whose row trees select from the flat tables (msm's route
    at 128 lanes): ``tail_horner``'s operations; the entries the (B, rows,
    128) digits select (``_selected_bytes``) and the digits in, the result
    out."""
    batch, rows, _ = absd.shape
    ops = tail_horner(batch, rows, canonical)[0]
    return ops, _selected_bytes(absd, sgn) + absd.numel() * DIGIT_BYTES + batch * PT_BYTES


def tail_horner_chain(rows: int):
    """(point operations, product rounds) of tail_horner's chain: the rows'
    128-lane trees at once, each addition on a group of threads (the 32
    groups of ``ops/kernels.py: TAIL_ROWS_THREADS / TAIL_ROWS_GROUP`` a row:
    the first level's 64 additions two a group in turn, then one in each of
    the 6 levels after it, 8 additions), then Horner on one warp (4
    doublings and 1 addition a row); 2 rounds an operation."""
    ops = 8 + 5 * rows
    return ops, 2 * ops


def horner_chain(rows: int):
    """horner's chain, one warp per MSM: 4 doublings and 1 addition a row,
    2 rounds each."""
    return 5 * rows, 2 * 5 * rows


def select_reduce_fused_chain(rows: int):
    """select_reduce_fused's chain, one thread per lane or (row, column): the
    build's 7 additions, then the rows 11 at a time, 7 additions a row."""
    ops = 7 + -(-rows // 11) * 7
    return ops, ops * ADD_PRODUCTS


def fold_chain(rows: int):
    """fold's chain, one warp per lane: a row's sum of its two entries, then
    4 doublings and + that sum, in turn (6 operations a row), 2 rounds
    each."""
    return 6 * rows, 2 * 6 * rows


def fold_many_chain(rows: int, group: int):
    """fold_many's chain, a lane on a group of ``group`` threads: the tables'
    7 additions (at group 16 or 32 the two tables at once, each on half the
    group; at 8 one after the other: 14), then the rows.  At 16 and 32 the
    first row's sum of its two entries, then 4 doublings and 1 addition a
    row (``csrc/kernels.cu: fold_rows``: the next row's sum is made by the
    other half of the group beside it); at 8 each row's sum, 4 doublings
    and + the sum in turn (6 a row).  2 rounds each."""
    ops = 7 + 1 + 5 * rows if group >= 16 else 14 + 6 * rows
    return ops, 2 * ops


def fold_phi_chain(rows: int, group: int):
    """fold_many's chain with phi: phi's product (one round) before O's
    table, then fold_many's."""
    ops, rounds = fold_many_chain(rows, group)
    return ops, rounds + 1


def complete_square_chain(rows: int, group: int):
    """complete_square's chain, a lane on a group of ``group`` threads: phi's
    product (one round) before O's table, fold_many's chain, then the two
    additions (at group 16 one on each half at once; at 8 one after the
    other), 2 rounds each."""
    ops = fold_many_chain(rows, group)[0] + (1 if group >= 16 else 2)
    return ops, 2 * ops + 1


def table_flat_chain(design: str):
    """table_flat's chain, a lane's 7 additions: 12 product rounds each on
    one thread (``"wide"``), 2 on a group of threads (``"narrow"``)."""
    return 7, 7 * _add_rounds(design)


def padd_chain(design: str):
    """padd's chain, one addition: 12 rounds wide, 2 narrow."""
    return 1, _add_rounds(design)


def _add_rounds(design: str) -> int:
    return {"wide": ADD_PRODUCTS, "narrow": 2}[design]


def table_flat(n: int):
    return n * (7 * PT_ADD + 9 * FE_SUB), n * (PT_BYTES + (9 + 18 + 9) * FE_BYTES)


def select_reduce(absd, sgn, factor: int = 8):
    """Reads: X, Y and Z of each lane's distinct nonzero |d| over its rows
    (entry 0 is the identity; a negative digit's -Y is made from Y, 2
    multiplies), the digits; the partials out.  (A gather from the flat
    tables reads X and Z by |d| and Y by |d| + 9 s, entry 0 and the table's
    -Y included: ``_selected_bytes``, sr_variant's count.)"""
    n = absd.numel()
    ops = (n // factor) * (factor - 1) * PT_ADD + int(sgn.sum()) * FE_SUB
    entries = _distinct(absd, 9) - int((absd == 0).any(1).sum())
    return ops, 3 * entries * FE_BYTES + n * DIGIT_BYTES + (n // factor) * PT_BYTES


def fold(n: int, digits):
    """digits: (4, rows) host ints de, se, do, so, shared by all lanes and
    sent in the launch, not read from device memory."""
    rows = len(digits[0])
    entries = 0
    for d, s in ((digits[0], digits[1]), (digits[2], digits[3])):
        entries += 2 * len(set(int(v) for v in d)) + len({int(a) + 9 * int(b) for a, b in zip(d, s)})
    ops = n * rows * (4 * PT_DBL + 2 * PT_ADD)
    return ops, n * (entries * FE_BYTES + PT_BYTES)


def fold_many(n: int, digits):
    """B provers' folds of n / B lanes each in one launch, from the two
    bases' points (digits: (B, 4, rows)): the multiplies of their ``fold``
    bounds and of the two tables the launch builds (``table_flat``'s, of n
    lanes each); the two bases' points read and the result written (the
    tables never leave the SM).  The chain: ``fold_many_chain``."""
    ops = sum(fold(n // len(digits), d)[0] for d in digits) + 2 * table_flat(n)[0]
    return ops, n * 3 * PT_BYTES


def fold_phi(n: int, digits):
    """``fold_many`` of n lanes whose O basis is phi(E), made in the launch:
    its multiplies and phi's product a lane; E read, the result written."""
    return fold_many(n, digits)[0] + n * FE_MUL, n * 2 * PT_BYTES


def complete_square(n: int, digits):
    """B provers' square completions of n / B lanes each in one launch
    (digits: (B, 4, rows)): ``fold_many``'s multiplies, phi's product, the
    negation and the two additions a lane; g0 and g1 read, g1 + r g0 and
    g1 - r g0 written (the tables and r g0 never leave the SM)."""
    ops = fold_many(n, digits)[0] + n * (FE_MUL + FE_SUB + 2 * PT_ADD)
    return ops, n * 4 * PT_BYTES


def select_reduce_fused(absd, sgn):
    batch, rows, L = absd.shape
    n = absd.numel()
    ops = batch * L * 7 * PT_ADD + (n // 8) * 7 * PT_ADD + int(sgn.sum()) * FE_SUB
    return ops, batch * L * PT_BYTES + n * DIGIT_BYTES + (n // 8) * PT_BYTES


def decompress(n: int):
    return n * DECOMPRESS, n * (FE_BYTES + 8 + FE_BYTES + 1)


def inv(n: int):
    return n * INV, n * 2 * FE_BYTES


def to_affine(n: int):
    """x, y and z in; x z^-1, y z^-1 and the identity mask (a byte) out."""
    return n * (INV + 2 * FE_MUL), n * (3 * FE_BYTES + 2 * FE_BYTES + 1)


def select_small(absd, sgn):
    """The entries the digits select (``_selected_bytes``: the gather reads X
    and Z by |d|, Y by |d| + 9 s), the digits, the selected points out; no
    multiplies."""
    n = absd.numel()
    return 0, _selected_bytes(absd, sgn) + n * DIGIT_BYTES + n * PT_BYTES


def endo(n: int, interleave: bool):
    """beta x a lane; with ``interleave`` the three planes in and twice their
    lanes out, else x in and beta x out."""
    if interleave:
        return n * FE_MUL, n * 3 * PT_BYTES
    return n * FE_MUL, n * 2 * FE_BYTES


def pneg(n: int):
    return n * FE_SUB, n * 2 * FE_BYTES


def normalize3(n: int):
    """Three planes in, three out; ``fe_canon`` has no multiply."""
    return 0, n * 2 * PT_BYTES


def assemble(n_in: int, n_out: int, interleave: bool):
    """The segments' n_in lanes read once and the n_out output lanes (the
    identity pads included) written once; with ``interleave`` one product
    beta x a lane read.  The segment table travels in the launch's
    parameters, not through device memory."""
    return (n_in * FE_MUL if interleave else 0), (n_in + n_out) * PT_BYTES


def reduce_lanes(absd, sgn):
    """The fused select and lane tree: (L - 1) additions a (MSM, row) pair;
    the table entries its digits select (``_selected_bytes``, as
    ``select_small``) and the digits in, its sum out."""
    batch, rows, L = absd.shape
    ops = batch * rows * (L - 1) * PT_ADD
    return ops, _selected_bytes(absd, sgn) + absd.numel() * DIGIT_BYTES + batch * rows * PT_BYTES


def reduce_lanes_tree(batch: int, rows: int, L: int):
    """The tree alone: its L selected lanes a pair in, its sum out."""
    return batch * rows * (L - 1) * PT_ADD, batch * rows * (L + 1) * PT_BYTES


def reduce_lanes_chain(L: int):
    """reduce_lanes' chain, a pair's: the log2 L levels of its tree, one
    addition of 2 product rounds each on a group of threads."""
    levels = L.bit_length() - 1
    return levels, 2 * levels


def sr_variant(absd, sgn, blk: int, out_w: int, noselect: bool):
    factor = blk // out_w
    rows, L = absd.shape
    n = rows * L
    ops = (n // factor) * (factor - 1) * PT_ADD
    reads = L * PT_BYTES if noselect else _selected_bytes(absd[None], sgn[None]) + n * DIGIT_BYTES
    return ops, reads + (n // factor) * PT_BYTES


def grid_copy(L: int, rows: int):
    return 0, L * FE_BYTES + rows * L * FE_BYTES


def chain(phase: str, n: int, rep: int):
    nstate = 3 if phase == "padd" else 1
    nb = 3 if phase == "padd" else (0 if phase == "mul_small" else 1)
    return n * rep * CHAIN_STEP[phase], n * (nstate + nb + 1) * FE_BYTES
