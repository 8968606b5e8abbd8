"""The launch geometry of the MSMs' last launches on the CPU: tail_rows'
thread groups and horner's split product, as ``ops/kernels.py`` states
them against the constants of ``csrc/kernels.cu`` and ``csrc/tools.cu``;
the order in which tail_rows' groups add a row's 128 lanes against the
plain version's halving order (the same nesting: the same words).  No
launch."""

import os
import re

from bulletproofspp_tpu_torch import bounds
from bulletproofspp_tpu_torch.ops import kernels


def _source(name: str) -> str:
    with open(os.path.join(kernels.CSRC, name)) as f:
        return f.read()


def _constexpr(src: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def test_tail_rows_and_horner_geometry_is_the_kernels():
    """TAIL_ROWS_GROUP, TAIL_ROWS_THREADS and HORNER_SPLIT are kernels.cu's
    kTailGroup, kTailThreads and kHornerSplit; the block is whole warps of
    whole groups, two of the first level's 64 additions a group; horner's
    rounds fit the warp (an addition's 6 products on S threads each)."""
    src = _source("kernels.cu")
    assert _constexpr(src, "kTailGroup") == kernels.TAIL_ROWS_GROUP
    assert _constexpr(src, "kTailThreads") == kernels.TAIL_ROWS_THREADS
    assert _constexpr(src, "kHornerSplit") == kernels.HORNER_SPLIT
    assert kernels.TAIL_ROWS_THREADS % 32 == 0 and 32 % kernels.TAIL_ROWS_GROUP == 0
    assert 2 * (kernels.TAIL_ROWS_THREADS // kernels.TAIL_ROWS_GROUP) == 64
    assert kernels.TAIL_ROWS_GROUP >= 6 and 6 * kernels.HORNER_SPLIT <= 32
    for tables in ("true", "false"):
        assert f"tail_rows_kernel<{tables}><<<blocks, kTailThreads" in src
    assert "horner_rows_warp<kHornerSplit>" in src


def _kernel_order(groups: int):
    """The row sum tail_rows_kernel makes of lanes 0..127, as nested (first,
    second) operand pairs, by its loop over shared memory's 2 * groups
    slots: group g adds lanes (g + 32 i, g + 32 i + 64) into slot g + 32 i
    (32 groups)
    for i = 0, 1; then at each level of h = groups .. 1 additions, group g
    < h adds slots g and g + h into slot g."""
    slots = [None] * (2 * groups)
    for i in (0, 1):
        for g in range(groups):
            slots[g + groups * i] = (g + groups * i, g + groups * i + 64)
    h = groups
    while h >= 1:
        for g in range(h):
            slots[g] = (slots[g], slots[g + h])
        h //= 2
    return slots[0]


def test_tail_rows_order_is_the_plain_halving_order():
    """The kernel's schedule, at its groups a row (two of the first level's
    additions a group), nests the 127 additions as tail_horner_plain's
    halving levels do: pairs t, t + 64, then t, t + 32, ... with the lower
    lane first."""
    v = list(range(128))
    while len(v) > 1:
        h = len(v) // 2
        v = [(v[t], v[t + h]) for t in range(h)]
    assert _kernel_order(kernels.TAIL_ROWS_THREADS // kernels.TAIL_ROWS_GROUP) == v[0]


def test_tail_horner_chain_follows_the_group_schedule():
    """The chain a row's group runs: the first level's 64 / 32 additions in
    turn, then one a level for 6 levels, then Horner's 5 operations a row;
    2 product rounds each."""
    tree = 64 // (kernels.TAIL_ROWS_THREADS // kernels.TAIL_ROWS_GROUP) + 6
    for rows in (1, 2, 33):
        assert bounds.tail_horner_chain(rows) == (tree + 5 * rows, 2 * (tree + 5 * rows))


def test_round_phases_are_the_chain_kernels():
    """kernels.ROUND_PHASES (index, addition, G, S) are tools.cu's round
    phases: each index the enum's, each launched at its G and S, and the
    (G, S) of horner's and tail_rows' rounds among them."""
    src = _source("tools.cu")
    enum = re.search(r"enum Phase \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"^\s*(k\w+),", enum, re.M)
    rounds = {m[0]: (m[1] == "true", int(m[2]), int(m[3]))
              for m in re.findall(r"BPPP_ROUND\((k\w+), (true|false), (\d+), (\d+)\)", src)}
    assert len(rounds) == len(kernels.ROUND_PHASES)
    for name, (idx, add, G, S) in kernels.ROUND_PHASES.items():
        assert rounds[names[idx]] == (add, G, S), name
        assert S * (6 if add else 4) <= G <= 32, name
    by_gs = {(v[2], v[3], v[1]) for v in kernels.ROUND_PHASES.values()}
    assert {(32, kernels.HORNER_SPLIT, True), (32, kernels.HORNER_SPLIT, False), (32, 1, True),
            (32, 1, False), (kernels.TAIL_ROWS_GROUP, 1, True)} <= by_gs
