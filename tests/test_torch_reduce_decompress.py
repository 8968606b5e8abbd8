"""The chains of the redesigned reduce_block and decompress, held on the
CPU: decompress's square-root addition chain (``bounds.SQRT_CHAIN``)
against Python's ``pow`` on seeded integers and against the steps that
``csrc/decompress.cu`` runs, the schedule of the inverse
(``csrc/field.cuh: fe_inv_divsteps``) against ``bounds.py``'s, and the
chain lengths and work that ``bounds.py`` gives both kernels."""

import os
import re

import numpy as np
import pytest

from bulletproofspp_tpu_torch import bounds
from bulletproofspp_tpu_torch.ops import kernels

P = 2**256 - 2**32 - 977


def _sqrt_chain_pow(a: int) -> int:
    """a^((p+1)/4) mod p by bounds.SQRT_CHAIN: each step (s, k) squares s
    times, then multiplies by a^(2^k - 1), which an earlier step made."""
    made, e, r = {1: a}, 1, a  # made[k] = a^(2^k - 1); r = a^e
    for s, k in bounds.SQRT_CHAIN:
        r = pow(r, 1 << s, P)
        e <<= s
        if k:
            r = r * made[k] % P
            e += (1 << k) - 1
        if (e + 1) & e == 0:  # e = 2^k - 1
            made[e.bit_length()] = r
    assert e == (P + 1) // 4
    return r


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sqrt_chain_equals_pow_on_seeded_integers(seed):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(64)] + [0, 1, P - 1]
    for a in xs:
        assert _sqrt_chain_pow(a) == pow(a, (P + 1) // 4, P)


def test_sqrt_chain_counts_253_squarings_and_13_multiplications():
    assert bounds.SQRT_SQUARINGS == 253 and bounds.SQRT_PRODUCTS == 13
    # square-and-multiply over (p+1)/4 below its top bit: 253 and 246
    e = (P + 1) // 4
    assert (e.bit_length() - 1, bin(e).count("1") - 1) == (253, 246)
    # the exponent's blocks of ones: 223, then 22, then 2 (from the top)
    assert [len(b) for b in bin(e)[2:].split("0") if b] == [223, 22, 2]


def _source_steps(source="decompress.cu", head="Fe fe_sqrt_candidate("):
    """(squarings, multiply-by k) of each step of a chain's function (by
    default decompress.cu's fe_sqrt_candidate), read from its code, and the
    (s, k) its comments give; a call of field.cuh's fe_ladder stands for
    the ladder's steps, read the same way."""
    with open(os.path.join(kernels.CSRC, source)) as f:
        src = f.read()
    body = src[src.index(head):]
    body = body[:body.index("\n}\n")]
    code, comments = [], []
    for line in body.splitlines():
        if "= fe_ladder(a);" in line:
            c, n = _source_steps("field.cuh", "FeLadder fe_ladder(")
            code += c
            comments += n
            continue
        note = re.search(r"// \((\d+), (\d+)\)$", line)
        if not note:
            continue
        comments.append((int(note.group(1)), int(note.group(2))))
        sq = re.search(r"fe_sqr_n\([\w.]+, (\d+)\)", line)
        s = int(sq.group(1)) if sq else line.count("fe_sqr(")
        mul = re.search(r"fe_mul\(.*, (?:l\.)?(\w+)\);", line)
        k = 0 if not mul else 1 if mul.group(1) == "a" else int(mul.group(1)[1:])
        code.append((s, k))
    return code, comments


def test_decompress_source_runs_the_chain_its_comments_give():
    code, comments = _source_steps()
    assert code == comments == list(bounds.SQRT_CHAIN)


def test_inv_source_runs_the_chain_its_comments_give():
    """field.cuh's fe_inv_divsteps, which both affine kernels run: the
    batches and divsteps a batch of bounds.py (and of its comment), p^-1 mod
    2^30; the Fermat chain is gone."""
    with open(os.path.join(kernels.CSRC, "field.cuh")) as f:
        field = f.read()
    with open(os.path.join(kernels.CSRC, "affine.cu")) as f:
        affine = f.read()
    consts = dict(re.findall(r"constexpr \w+ (k\w+) = (0x[0-9a-f]+|\d+)u?;", field))
    assert int(consts["kDivstepBatches"]) == bounds.DIVSTEP_BATCHES
    assert int(consts["kDivstepsABatch"]) == bounds.DIVSTEPS_A_BATCH
    assert int(consts["kPInv30"], 16) == pow(P, -1, 1 << 30)
    note = re.search(r"constexpr int kDivstepBatches = \d+;  // \((\d+) batches of (\d+) divsteps\)",
                     field)
    assert (int(note.group(1)), int(note.group(2))) == (bounds.DIVSTEP_BATCHES,
                                                         bounds.DIVSTEPS_A_BATCH)
    assert "Fe fe_inv(" not in field and "fe_inv(" not in affine
    assert affine.count("fe_inv_divsteps(") == 2  # inv_kernel and to_affine_kernel


def test_decompress_work_and_chain_count_the_new_chain():
    """x^2 and r^2 are squarings too: 255 at 98 multiplies (36 word
    products), 14 products at 146 (64); the old square-and-multiply chain
    was 502 products at 146."""
    assert bounds.FE_SQR == 2 * 36 + 3 * 8 + 2 and bounds.FE_MUL == 2 * (64 + 8 + 1)
    assert bounds.DECOMPRESS == 255 * bounds.FE_SQR + 14 * bounds.FE_MUL + 4
    old = (2 + 253 + 246 + 1) * bounds.FE_MUL + 4
    assert 2.5 < old / bounds.DECOMPRESS < 3
    assert bounds.decompress_chain() == 2 + 253 + 13 + 1
    ops, nbytes = bounds.decompress(16384)
    assert ops == 16384 * bounds.DECOMPRESS and nbytes == 16384 * (128 + 8 + 128 + 1)


@pytest.mark.parametrize("f,narrow,chain", [
    # F - 1 additions of 12 products one after another on one thread
    (2, False, (1, 12)), (4, False, (3, 36)), (8, False, (7, 84)),
    # log2 F levels of the halving tree, 2 rounds of 6 products an addition
    (2, True, (1, 2)), (4, True, (2, 4)), (8, True, (3, 6)),
])
def test_reduce_block_chain_by_design(f, narrow, chain):
    assert bounds.reduce_block_chain(f, narrow) == chain
