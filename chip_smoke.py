"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, prove, verify, batch-verify, multiparty, shard, convert, measure, bench, assemble.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. print the card (``nvidia-smi`` name and power limit) and build the
     CUDA kernels from ``bulletproofspp_tpu_torch/csrc`` with nvcc (one
     process per source file, all at once);
  2. hold each kernel (padd, horner, reduce_block, tail_horner,
     table_flat, select_reduce, fold, select_reduce_fused, decompress,
     sr_variant, grid_copy, chain) against its plain PyTorch version on
     the card, at the shapes the main paths give it, on numpy-seeded
     inputs (identity lanes, P + P, P + (-P) and non-residue x's
     included; padd and table_flat at 16 to 65,536 lanes
     (``kernels.PADD_WIDTHS``, ``kernels.TABLE_FLAT_WIDTHS``) and
     reduce_block at the main paths' (W, factor) launches
     (``kernels.REDUCE_BLOCK_WIDTHS``), each launch
     checked to take the design its lane count picks and to equal the
     other design word for word, both designs timed in turns, the narrow /
     wide ratio logged, and where the wrapper takes narrow, narrow no
     slower than wide; decompress at 16, 64 and 16,384 lanes, y and ok
     on every lane; padd's wide design at 65,536 lanes also
     in each of its threads-a-block instantiations, and a launch's floor
     logged (one field addition at 16 lanes); horner at 1, 2 and 130
     MSMs with an all-identity row and a row that cancels or doubles the
     accumulator, word for word; tail_horner at 1, 3 and
     130 MSMs with an all-identity and a cancelling row; select_reduce at
     one, three and 130 MSMs of 4,096 lanes with a row of zero digits and
     sign 1, each launch checked to take the design its lane count picks
     and to equal the other design, and at 65,536 lanes; fold at 16, 520
     and 512 lanes, zero digits
     with sign 1 in both streams at 16 and 520; fold_many, the batched
     fold of the lockstep prover, from the two bases' points (its tables
     built in its launch) at B = 2 and 16 provers of L = 16 and 512 lanes
     and B = 4 of 512,
     each prover with its own digits and prover 0's streams with zero
     digits and sign 1, no table_flat launch, its three group widths equal
     raw and timed in turns, the wrapper in turns with the route it
     replaced (two table_flat launches and B fold launches on the same
     lanes), and at B = 1 equal word for word to table_flat + fold; the
     one-prover fold (``msm.fold_mul``'s and ``shared_mul``'s route) at
     ``FOLD_ONE_LANES`` (16, 512 and 4,096 lanes): fold_many at B = 1 and
     its phi form (``kernels.fold_phi``, the O basis phi(E) made in the
     launch), one fold_many launch each, equal word for word to table_flat
     x 2 + fold and to endo + table_flat x 2 + fold, timed in turns with
     them;
     complete_square, the square completion in one launch (phi, fold_many's
     fold and g1 +- r g0), at ``CSQ_CASES`` (B provers of L lanes: 1 x 16
     and 256, 2 x 16, 16 x 16, 4 x 64, and 16 x 128, 2,048 lanes, the
     8-thread group), one launch and no other, equal word for word to the
     unfused route (endo, fold_many, padd, pneg, padd) and timed in turns
     with it): the normalized outputs must be equal limb for limb.  Time both: a kernel's launches back to
     back (enqueued while the stream sleeps), a plain version's as the host
     sends them.  select_reduce is timed in turns with its yardsticks on
     the same inputs: at 4,096 lanes (its gather design) with sr_variant
     (blk 1,024 / out 128: its function, on the staged row phase), at 65,536
     (its staged design) with sr_variant, sr_variant noselect and its gather
     design (all equal to it limb for limb); chain's ten phases on lanes
     with edge values (``edge_planes``), mul_f16, add and sub also equal
     raw, at 1 and 8 steps, to field.cuh's representative
     (``kernels.field_words``), and its round phases
     (``kernels.ROUND_PHASES``: the point chains' rounds, fold_rows' split
     product among them) at 4,096 lanes against their plain versions, 1 and
     8 steps (phase_bench, in phase 8, times them on one warp and prints
     each round's parts and the old and new fold_rows round).
     select_reduce_fused, with a
     row of zero digits and sign 1, equals the two kernels table_flat +
     select_reduce limb for limb (raw) at 4,096 lanes and at 2^21 lanes,
     and is timed in turns with them, each route's peak device memory
     above its inputs logged; at 2^21 lanes its plain version runs three
     rows at a time (its gather of all rows alone is 3 x 8.9 GB);
  3. reset the launch counts and run the port's CLI ``test`` command
     (prove, verify, encode, decode, verify) on every shipped example
     (examples/*): rc 0 and proof/commitment bytes equal to the golden
     digests of tests/test_golden.py (read from that file);
  4. require that every kernel of that path was launched during phase 3
     and that no module of JAX or of the JAX package was imported;
  5. time ``prove`` and ``verify`` per example through the same CLI and
     check that a proof with one flipped byte is rejected (rc 1);
  6. the 2^21-lane MSM: ``TorchEngine.msm`` over 2^20 (scalar, point)
     pairs (64 host multiples k_b G, repeated; numpy-seeded scalars), equal
     to (sum_i s_i k_b(i) mod R) G from exact host integers; counted from
     0, select_reduce_fused must launch and select_reduce and table_flat
     must not; then once more under ``torch.profiler`` for its device time;
  7. the 1,024-proof batch: prove 1,024 distinct examples/64bit proofs
     (amount 10^9 + i, seed bench<i>) through ``TorchEngine`` on the card,
     two of them equal byte for byte to ``HostEngine``'s; counted from 0,
     the port's CLI ``batch-verify`` accepts them all (rc 0); with one byte
     of proof 517 flipped it rejects the batch (rc 1), and
     ``verify_many_encoded`` flags proof 517 alone; then one timed
     ``batch_verify_encoded`` by engine call (engine_profile's batch mode);
  8. the measurement path, run between phases 5 and 6 so that the bench's
     torch.profiler sessions are the process's first: sr_variant (every
     (blk, out_w) of the r5 tool's H3/H4, and noselect; at blk 1,024 / out
     128 equal to select_reduce limb for limb), grid_copy and chain (all
     ten phases) against their plain versions at L = 65,536 (in phase 2);
     then, counted
     from 0, the port's bench in-process at 32,768 points (tabled =
     untabled = the host answer, every IQR under 10%) and the mains of
     tools.r5_experiments and tools.phase_bench once each;
  9. the batch prover: counted from 0, the port's CLI ``prove-batch`` over
     32 items of examples/ (16 x 64bit, a full lockstep chunk; 4 each of
     32bit, rec_test and bin_test; 2 each of 64by64 and 128by64): every
     proof and commitment equal byte for byte to ``range_proof.prove``
     through ``TorchEngine`` one at a time with the same setup, values and
     seed (``<randomSeed>#i``), two of them also to ``HostEngine``'s, every
     proof verifies, and fold_many launched with a 16-prover shape among
     its launches; logged: the CLI's wall seconds, and in this process the
     seconds of the same proofs through ``prove_many`` and one at a time,
     and the fold launches of both routes; then ``engine_profile``'s
     lockstep profile (16 64bit proofs in one bucket against one at a
     time);
  10. the proof service: ``serve.ProofServer`` in this process on
     ``TorchEngine``, warmed with 64bit at sizes 1 to 16; counted from 0,
     over one pipelined connection 16 64bit and 2 128by64 prove requests
     with phase 9's seeds (answers equal to phase 9's bytes), 8 verifies
     of phase 9's proofs (valid) and one with a flipped byte (not valid),
     and a malformed request (ok false, its batchmates unharmed); then
     ``stats`` (18 proved, 9 verified); then the CLI's ``serve`` as a
     subprocess, which must print ``serving on host:port`` and answer one
     verify request before it is terminated;
  11. multiparty proving: counted from 0, the CLI's ``mp-prove`` of
     examples/128by64 over 4 parties of 32 ranges three ways (``--local``
     threads on the dealer's engine; 4 party processes on the card; 4 with
     ``--party-engine host``) and of examples/bin_test over 2 party
     processes: each rc 0 and "...: True", its files accepted by the CLI's
     ``verify`` here and in another process, a flipped byte rejected there
     (rc 1); every kernel that phase 3's ``cli test`` of 128by64 launched
     must launch on this path.  Then the CLI's ``prove`` of 128by64 (the
     wall seconds of the three mp-prove runs and of it are logged); in this
     process one party owning all 128 ranges (seed ``randomSeed``) equal to
     ``range_proof.prove`` and to the golden digest, and 4 seeded parties
     on ``TorchEngine`` equal to the same run on ``HostEngine``; ``mp-demo
     --parties 3`` over TCP and ``--local`` ("True"); ``fold_bases`` and
     ``shared_mul`` at 16, 512 and 4,096 lanes equal to ``HostEngine``'s,
     each call exactly one fold_many and one ``to_affine`` launch; and
     ``engine_profile``'s multiparty profile (4 parties and the dealer
     on one engine against one prover);
  12. the sharded MSM: (a) log ``torch.cuda.device_count()``; (b) hold the
     kernels that take a row count at the sharded rows_local of 17 (win =
     2) and 9 (win = 4), 4,096 lanes, MSB zero rows with sign 0 and a zero
     row with sign 1: select_reduce (both designs, equal word for word),
     select_reduce_fused (equal word for word to table_flat +
     select_reduce), reduce_block and tail_horner against their plain
     versions limb for limb, horner word for word; then, counted from 0,
     (c) phase 6's MSM through ``ShardedTorchEngine`` on a mesh of two
     entries in this process (two cards, or ``cuda:0`` twice) at win 1 and
     2; (d) ``dryrun.dryrun_multiprocess`` with 2 rank processes over gloo
     (rank r on ``cuda:r``, or both on ``cuda:0``): the same MSM at win 2
     and 1, and phase 7's 1,024 proofs through ``ShardedTorchEngine`` on
     the 2-rank mesh, accepted, and rejected with proof 517 flipped; (e)
     ``dryrun.dryrun_multichip(2, "cuda")``.  Every MSM equals phase 6's
     host answer; logged: each run's wall seconds, launches, device seconds
     under ``torch.profiler``, peak device memory and gather seconds.
  13. device affine conversion: (a) inv and to_affine against their plain
     versions at 16, 512, 4,096 and 65,536 lanes with edge lanes (z = 0,
     Q, Q - 1, x = 0, saturated limbs, values in [Q, 2^256)), word for
     word, each timed at 16, 4,096 and 65,536; (b) counted from 0, the
     affine path at 4,096 lanes alone: one ``fold_bases`` and one
     ``shared_mul`` on ``TorchEngine``, which launch fold_many 2 (the second
     making phi in its launch), to_affine 2 and no other kernel (``inv`` is
     on no path: the JAX
     package calls ``limb.inv`` / ``batch_inv`` only from ``to_affine``,
     which the to_affine kernel fuses); then, after the counts are read,
     both equal to their route before device conversion
     (``DevicePoints.to_host``, one host inverse a lane) and to the JAX
     package's route through the port's field (``limb.batch_inv`` of the
     fold's Z, ``limb.inv``); both routes' walls logged in turns, with the
     host inverses' seconds alone.
  14. the bench's proof legs: 1,024 bench proofs generated anew
     (``bench.gen_proofs``: HostEngine in spawned workers); then, each
     counted from 0, ``bench_proofs``, ``bench_mixed``, ``bench_serve`` and
     ``bench_batch_1024`` (over those proofs) in this process at the
     reference's default sizes (BENCH_* unset: 3 waves each) on one
     ``TorchEngine``: each leg's ``*all_valid`` true, the line it prints on
     stderr equal to what it returns and holding the keys of the root
     bench.py's line (read from its source) and the card's; each leg
     launching its ``BENCH_REQUIRED`` kernels; logged: each line, its
     wall seconds and its launches by kernel.  Then ``python -m
     bulletproofspp_tpu_torch.bench`` as a subprocess with BENCH_ONLY=batch
     and BENCH_BATCH_N=16: rc 0, one valid batch line of 16 proofs on
     stderr, no MSM line.
  15. the lane-wise kernels (``csrc/lanes.cu``): (a) select_small, endo,
     pneg and normalize3 against their plain versions with edge lanes
     (``edge_planes``) among the inputs: select_small at B = 1, 2, 6, 66
     MSMs of L = 16, 64, 128, 512 lanes word for word; endo interleaved at
     8 to 2,048 lanes, at (16, K, n) stacks and at 32,768 and 2^20 lanes
     (``ENDO_WIDE``: the bench's basis and the sharded MSM's pairs, both
     timed), endo and pneg at 16 to 512
     lanes and lockstep's 16 x 16, equal after normalization and strict;
     normalize3 at K = 1, 2, 6, 66, 130 word for word; each timed at the
     main paths' commonest shapes, select_small in turns with
     select_plain's three torch.gather (its ``library_ms``); (a') msm's
     route from 128 to 1,023 lanes, which no longer launches select_small
     nor normalize3: reduce_block (both designs, L = 256, 512) and
     tail_horner (L = 128) reading their first level from the tables and
     the uint8 digits, at B = 1, 2, 6 MSMs of 33 rows (zero digits with
     sign 1, rows of P + (-P) and P + P, identity lanes), equal word for
     word to select_small + the kernel on its planes, and to their plain
     versions after normalization; tail_horner and horner (K = 1, 2, 130)
     canonical equal word for word to normalize3 of their projective
     stores; timed at cli test's commonest shapes, at B = 1 (narrow) and
     2 (wide) of 512 lanes and horner at K = 1, in turns with select_small
     + the kernel (the narrow design no slower) and horner with its
     projective stores (the ratio logged); (b) the library remainder: 16
     (c).
  16. the engine's assembly and the small MSMs' select and lane tree: (a)
     assemble against its plain version with edge lanes (``edge_planes``)
     in every input, word for word but for the phi lanes (strict, equal
     after normalization): msm_many's K = 1, 2, 3, 66 and 130 entries of
     1-4 groups whose active counts are not powers of two, at every lane
     bucket phase 3 gave that K; bv_split's halves of 33 and 4,095 lanes;
     lockstep's two stacks of 16 x 16; a 4,096-lane fold_bases' two bases;
     two calls whose segment table must split into launches by entries (260
     entries of 4 groups; 130 of 4 at the pre-12.1 limit's 4,048 bytes a
     launch), each launching more than once; timed at the shape phase 3
     launched most; (b) the fused reduce_lanes (the select by digit and the
     lane tree in one launch) at L = 16, 32, 64 and B = 1, 2, 6, 66, 130
     MSMs of 33 rows (zero digits with sign 1, rows of P + (-P) and P + P,
     identity lanes), equal word for word to select_small + the padd
     kernel's tree and to select_small + its own tree alone (the plane
     route), and to its plain version after normalization; at the shape
     phase 3 launched most timed back to back, in turns with select_small
     + its tree alone, and stopped after each level in turns (the
     per-level figure); (c) in a process of its own for each route, one
     64bit verify and prove under ``torch.profiler`` with every kernel and
     with assemble and reduce_lanes swapped for their plain versions: the
     library remainder (device
     kernels no wrapper launches) in ms and launches, the memory copies by
     kind (host-to-device pinned and pageable, device-to-host) in ms and
     count, the port's launches, device seconds, idle share and the wall of
     each, logged on one line a route, and on the kernels' route one
     128by64 prove too: no library launch in either prove, no pinned
     host-to-device copy, no select_small or normalize3 launch, and the
     64bit prove's square completion in complete_square (no endo, pneg or
     padd); the plain route brings the eager select (and the digits'
     widening) back through reduce_lanes.
  Over all the main paths' launches: no select_small (every MSM selects in
  its first reduction), reduce_lanes only under 128 lanes; none of
  normalize3 on cli test (each MSM's result leaves horner canonical); no
  endo, pneg or padd on cli test, prove-batch and the service (their
  square completions launch complete_square), pneg on no path, and fold on
  no path (every fold, one prover's too, is fold_many's).

The line before the last is one JSON object with, for each kernel and
each shape it is timed at (select_reduce twice: 4,096 lanes, its gather
design, and 65,536, its staged design; horner at 130 MSMs and at 1, the
main paths' shape; select_reduce_fused at 4,096 lanes and at 2^21, its
route; padd at 1,056 lanes, the halving trees' commonest, and 65,536;
table_flat at 16, fold's, and 4,096; reduce_block at W = 33,792, f = 8,
the bench's second launch, and W = 16,896, f = 4, cli test's commonest;
decompress at 16 lanes, cli test's smallest, and 16,384; fold_many at B =
2 and 16 of L = 16 and 512 and B = 4 of 512, and at B = 1 with and without
phi at 16, 512 and 4,096; complete_square at each of
CSQ_CASES; inv and to_affine at 16, 4,096 and 65,536;
select_small at B = 2, L = 16 and B = 1, L = 512; endo interleaved at K =
2 of 8 lanes, 2,048, 32,768 and 2^20 lanes, and at 16 lanes; pneg at 16; normalize3 at
K = 2 and 130; assemble and reduce_lanes at the shape phase 3 launched
most, reduce_lanes with its unfused route's time in turns and its time
stopped after each level), the kernel's
launch count (summed over the main-path runs of phases 3, 6, 7, 8, 9, 10,
11, 12, 13 and 14, each counted from 0) in all, by path (``launches_by_path``: cli_test,
msm_2_21, batch_verify, measurement, prove_batch, serve, multiparty, sharded,
affine, bench_proofs, bench_mixed, bench_serve, bench_batch), by design and path for padd, table_flat, reduce_block and
select_reduce (``launches_by_design``) and by shape, largest normalized
difference, times (for padd, table_flat and reduce_block the design the
wrapper takes, from the in-turns timings), bound (``bounds``:
the larger of its 32-bit multiplies over the card's rate and its bytes
over 3.35 TB/s; for chain's ten launches the sum of theirs) and, for grid_copy, the time of one PyTorch call that
computes the same function (``library_ms``; for select_small
select_plain's three torch.gather; null where there is none).
The kernel lines of phase 2, and the JSON line (``chain``), also give, for
tail_horner, horner, fold, fold_many, complete_square, select_reduce_fused, padd,
table_flat, reduce_block and reduce_lanes, the time per point operation and per product round of the
kernel's longest dependent chain (``bounds.*_chain``; padd's, table_flat's
and reduce_block's by design, fold_many's by group width), for decompress
the time per dependent field product of its chain, and for inv and
to_affine the time per divstep batch of theirs (fold_many's rows also
``group_ms``, each group width's time, and ``replaced_route_ms``;
complete_square's ``unfused_route_ms``, in turns);
the last line is {"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
CUDA is not available.
"""

from __future__ import annotations

import ast
import collections
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
ROWS = 33
WIDE_LANES = 1 << 21  # msm.SCRATCH_TABLE_MIN_L: the fused kernel's route
BATCH_N, BATCH_BAD = 1024, 517
DECOMPRESS_L = 16384  # the 1,024-proof batch's decompress bucket
# phase 9's items: (example, count); 16 64bit proofs fill one lockstep chunk
PROVE_BATCH = (("64bit", 16), ("32bit", 4), ("rec_test", 4), ("bin_test", 4), ("64by64", 2),
               ("128by64", 2))
# (provers, lanes of each): lockstep's commonest and widest launches, and at
# 2,048 lanes the narrowest that takes the 8-thread group
FOLD_MANY_CASES = ((2, 16), (16, 16), (2, 512), (4, 512), (16, 512))
# lanes of the one-prover fold (fold_bases' and shared_mul's 16 to 4,096: at
# 4,096 fold_many takes the 8-thread group), fold_many at B = 1 with and
# without phi
FOLD_ONE_LANES = (16, 512, 4096)
ROUND_LANES = 4096  # chain's round phases, held against their plain versions
# (provers, lanes of each) of complete_square: the paths' square completions
# (one prover of 16 to 256 lanes, lockstep's 2 and 16 of 16, 4 of 64) and 16
# of 128, 2,048 lanes a launch, where it takes the 8-thread group
CSQ_CASES = ((1, 16), (1, 256), (2, 16), (16, 16), (4, 64), (16, 128))

# phase 11: mp-prove of the widest example over 4 parties of 32 ranges, the
# binary family (an assumed range) over 2, mp-demo over 3, and the engine's
# fold_bases / shared_mul at these widths
MP_EXAMPLE, MP_PARTIES = "128by64", 4
MP_BINARY, MP_BINARY_PARTIES = "bin_test", 2
MP_DEMO_PARTIES = 3
MP_LANES = (16, 512, 4096)
DEVICE = "cuda"  # the CLI's --device

# phase 13: the affine kernels' widths (fold_bases' 16 to 4,096 lanes and the
# measurement width), those timed, their edge values, and the path's lanes
AFFINE_WIDTHS = (16, 512, 4096, 65536)
AFFINE_TIMED = (16, 4096, 65536)
AFFINE_LANES = 4096

# phase 14: the kernels each proof leg of the bench must launch, and the
# size of the batch leg's run as a subprocess
BENCH_REQUIRED = {
    "proofs": {"fold_many", "table_flat", "horner", "tail_horner", "assemble", "reduce_lanes"},
    "mixed": set(),
    "serve": {"fold_many", "decompress"},
    "batch": {"decompress", "table_flat", "select_reduce", "reduce_block", "tail_horner"},
}
BENCH_SUBPROCESS_N = 16

# phase 15: the lane-wise kernels' shapes (the main paths' and a little
# beyond: msm_many stacks B MSMs of L lanes under 1,024, interleaves K
# entries of n lanes, endo and pneg over a prover's lanes or lockstep's 16
# x 16, as complete_square ran them before it took them in, normalize3 K
# results) and endo's interleave at the bench's basis (32,768 points) and
# the sharded MSM's 2^20 pairs (ENDO_WIDE)
SELECT_BATCHES = (1, 2, 6, 66)
SELECT_LANES = (16, 64, 128, 512)
ENDO_STACKS = ((2, 8), (3, 32), (5, 128), (66, 16))  # (K, n)
NEG_LANES = (16, 32, 64, 128, 256, 512)
NORMALIZE_K = (1, 2, 6, 66, 130)
# the shapes of phase 15's timed rows, among those checked: (B, L), (K, n), K
SELECT_TIMED = ((2, 16), (1, 512))
ENDO_TIMED = ((2, 8), (1, 2048))
ENDO_WIDE = (32768, 1 << 20)
NORMALIZE_TIMED = (2, 130)
# phase 15 (a'): the MSM route from 128 to 1,023 lanes with the select in its
# first launch (reduce_block at 256 and 512 lanes, tail_horner at 128) and
# horner's canonical stores, held at these (B, L) and K and timed in turns
# with the unfused routes at cli test's commonest shapes and at (B, L) of
# FUSED_TIMED (narrow: B = 1; wide, 8,448 output lanes: B = 2)
FUSED_BATCHES = (1, 2, 6)
FUSED_LANES = (128, 256, 512)
FUSED_TIMED = ((1, 512), (2, 512))
CANONICAL_K = (1, 2, 130)
CANONICAL_TIMED = 1  # horner's main-path shape, timed beside cli test's commonest K
# phase 16: msm_many's entry counts (each at the lane buckets phase 3 gave
# it), the groups an entry and the widths of the other assembly calls; the
# lane tree's widths and MSM counts; the library remainder's routes (no
# route: the kernels)
ASSEMBLE_K = (1, 2, 3, 66, 130)
ASSEMBLE_GROUPS = 4
SPLIT_LANES = (33, 4095)  # bv_split of an odd count
ASSEMBLE_SPLIT_K = 260  # entries of 4 groups: a table past one launch's parameters
ASSEMBLE_SMALL_CAPACITY = 4048  # table bytes a launch carries under CUDA before 12.1
REDUCE_LANES_L = (16, 32, 64)
REDUCE_LANES_B = (1, 2, 6, 66, 130)
ASSEMBLY_OPS = ("assemble", "reduce_lanes")
# the launches complete_square took in: none on cli test, prove-batch, serve
SQUARE_OPS = ("endo", "pneg", "padd")
# the plain routes bring the eager select back, with the digits' widening
# (select_plain's gathers take int64), through reduce_lanes: a 64bit prove's
# MSMs are all under 128 lanes.  reduce_block and tail_horner keep their
# kernels: tail_horner's plain version is the eager Horner too, ~57,000
# launches in a 64bit verify, past where a profile has lost launches.  No
# prove or verify launches endo or pneg (complete_square makes phi and the
# negation), and complete_square's plain version is the eager fold (tens of
# thousands of launches): it keeps its kernel
REMAINDER_ROUTES = {"kernels": (), "plain_assembly": ASSEMBLY_OPS}
REMAINDER_MAX = 0  # library launches a 64bit or 128by64 prove may make on the kernels' route
REMAINDER_PROVES = ("64bit", "128by64")  # profiled on the kernels' route
MEASURE_L = 65536  # the measurement tools' width (32,768 points)
SR_CASES = ((1024, 128, False), (1024, 128, True), (512, 128, False), (512, 256, False),
            (1024, 256, False), (2048, 128, False), (2048, 256, False))


def golden() -> dict:
    """{example: (proof sha256, commitments sha256)} of every shipped
    example, from the GOLDEN table of tests/test_golden.py."""
    with open(os.path.join(HERE, "tests", "test_golden.py")) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "GOLDEN" for t in n.targets))
    table = ast.literal_eval(node.value)
    if sorted(table) != sorted(os.listdir(os.path.join(HERE, "examples"))):
        raise AssertionError("tests/test_golden.py does not cover every shipped example")
    return {name: (proof, coms) for name, (proof, coms, _) in table.items()}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, paced: bool = False) -> float:
    """Device milliseconds per call of fn between two CUDA events.  A
    kernel's launches run back to back (``bench.cuda_ms``: enqueued while
    the stream sleeps; raises if they could not be).  ``paced``: as the
    host sends them, for the plain versions (more small launches than the
    queue holds)."""
    from bulletproofspp_tpu_torch import bench

    fn()  # warm-up
    torch.cuda.synchronize()
    if paced:
        return bench.events_ms(lambda k: fn(), reps)[0]
    ms, ahead = bench.cuda_ms(lambda k: fn(), reps)
    if not ahead:
        raise AssertionError("a kernel's launches could not be timed back to back")
    return ms


def in_turns(fns: dict, reps: int):
    """Back-to-back times of each fn, in the order given and then in reverse
    (a, b, b, a): ({name: mean of its two}, {name: [both]})."""
    times = {k: [] for k in fns}
    for k in [*fns, *reversed(fns)]:
        times[k].append(time_ms(fns[k], reps))
    return {k: sum(v) / 2 for k, v in times.items()}, times


def random_points(n: int, rng, dev):
    """n projective lanes on ``dev``: multiples of G with random Z scaling,
    about 1/8 identity lanes.  Returns the planes and the host affine list."""
    from bulletproofspp_tpu_torch.core import ec
    from bulletproofspp_tpu_torch.core.fields import Q
    from bulletproofspp_tpu_torch.ops import limb

    base = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=64)]
    xs, ys, zs, pts = [], [], [], []
    for i in range(n):
        if rng.integers(0, 8) == 0:
            z = int(rng.integers(1, 2**62))
            xs.append(0), ys.append(z), zs.append(0), pts.append(None)
            continue
        p = base[int(rng.integers(0, len(base)))]
        z = int(rng.integers(1, 2**62)) * (1 << 190) % Q
        xs.append(p[0] * z % Q), ys.append(p[1] * z % Q), zs.append(z), pts.append(p)
    return tuple(limb.from_ints(v, dev) for v in (xs, ys, zs)), pts


def rescale_and_negate(p, rng, negate_mask):
    """Another projective representative of the same lanes (Z scaled), with
    Y negated where ``negate_mask``: for P + P and P + (-P) lanes."""
    from bulletproofspp_tpu_torch.core.fields import Q
    from bulletproofspp_tpu_torch.ops import limb

    n = p[0].shape[-1]
    xs, ys, zs = (limb.unpack_ints(c) for c in p)
    ks = [int(k) for k in rng.integers(1, 2**62, size=n)]
    out = ([], [], [])
    for i in range(n):
        y = (Q - ys[i]) % Q if negate_mask[i] else ys[i]
        for c, v in zip(out, (xs[i], y, zs[i])):
            c.append(v * ks[i] % Q)
    return tuple(limb.from_ints(v, p[0].device) for v in out)


def wide_points(n: int, rng, dev, chunk: int = 1 << 21):
    """n projective lanes on ``dev``: 4,096 lanes of ``random_points``
    repeated, each lane scaled by its own random Z on the device (``chunk``
    lanes at a time), so no two lanes carry the same coordinates."""
    from bulletproofspp_tpu_torch.ops import limb

    k = min(n, 4096)
    p, _ = random_points(k, rng, dev)
    z = torch.as_tensor(rng.integers(0, 1 << 16, size=(limb.NLIMB, n)), device=dev)
    out = []
    for c in p:
        c = c.repeat(1, -(-n // k))[:, :n]
        out.append(torch.cat([limb.mul(c[:, a:a + chunk], z[:, a:a + chunk])
                              for a in range(0, n, chunk)], 1))
    return tuple(out)


def tail_lanes(K: int, rng, dev):
    """(16, K, ROWS * 128) lanes for tail_horner (``wide_points``); in every
    MSM row 0 is all identity and in row 1 lane t + 64 is the negation of
    lane t, scaled, so both rows sum to the identity."""
    from bulletproofspp_tpu_torch.ops import limb

    x, y, z = (c.reshape(16, K, ROWS, 128) for c in wide_points(K * ROWS * 128, rng, dev))
    x[:, :, 0], z[:, :, 0] = 0, 0
    k = torch.as_tensor(rng.integers(1, 1 << 16, size=(limb.NLIMB, K, 64)), device=dev)
    x[:, :, 1, 64:] = limb.mul(x[:, :, 1, :64], k)
    y[:, :, 1, 64:] = limb.neg(limb.mul(y[:, :, 1, :64], k))
    z[:, :, 1, 64:] = limb.mul(z[:, :, 1, :64], k)
    return tuple(c.reshape(16, K, ROWS * 128) for c in (x, y, z))


def horner_rows(K: int, rng, dev, rows: int = ROWS):
    """(16, K, rows) row sums for horner (``random_points``, each with its
    own Z): in every MSM row 0 is all identity, row 1 a multiple P of G and
    row 2 -16 P in even MSMs (16 P + (-16 P) after the doublings) and 16 P
    in odd ones (16 P + 16 P)."""
    from bulletproofspp_tpu_torch.core import ec
    from bulletproofspp_tpu_torch.core.fields import Q
    from bulletproofspp_tpu_torch.ops import limb

    x, y, z = (c.reshape(16, K, rows) for c in random_points(K * rows, rng, dev)[0])
    x[:, :, 0], z[:, :, 0] = 0, 0
    p = [ec.scalar_mul(int(k), ec.G) for k in rng.integers(1, 2**62, size=K)]
    sixteen = [ec.scalar_mul(16, q) for q in p]
    for r, pts in ((1, p), (2, [q if b % 2 else ec.neg(q) for b, q in enumerate(sixteen)])):
        zs = [int(v) * (1 << 190) % Q for v in rng.integers(1, 2**62, size=K)]
        for c, coords in zip((x, y, z), ([q[0] * k % Q for q, k in zip(pts, zs)],
                                         [q[1] * k % Q for q, k in zip(pts, zs)], zs)):
            c[:, :, r] = limb.from_ints(coords, dev)
    return x, y, z


def residue_mix(n: int, rng):
    """n x's < p, for about 1/8 of which x^3 + 7 is not a square."""
    from bulletproofspp_tpu_torch.core.fields import Q

    xs = []
    while len(xs) < n:
        want_square = rng.integers(0, 8) != 0
        while True:
            x = int.from_bytes(rng.bytes(32), "little") % Q
            v = (x * x * x + 7) % Q
            if (v == 0 or pow(v, (Q - 1) // 2, Q) == 1) == want_square:
                break
        xs.append(x)
    return xs


def compare(name, kernel_out, plain_out):
    """Largest difference of the normalized outputs (points or flat
    tables); raises unless it is 0."""
    from bulletproofspp_tpu_torch.ops import limb

    def canon(ts):
        return torch.cat([limb.normalize(t.reshape(-1, limb.NLIMB, t.shape[-1]).transpose(0, 1))
                          .reshape(limb.NLIMB, -1) for t in ts], 1)

    a, b = canon(kernel_out), canon(plain_out)
    err = int((a - b).abs().max().item())
    if err != 0:
        raise AssertionError(f"kernel {name} disagrees with its plain version: max |diff| {err}")
    return err


def same_raw(name, a, b):
    """Largest difference of the two outputs word for word; raises unless
    they are equal."""
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: the outputs differ word for word")
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max().item())
               for x, y in zip(a, b))


def designs_in_turns(name, label, by_design, picked, reps):
    """padd, table_flat or reduce_block at one shape (``label``: "L=16",
    "W=33792 f=8"): both designs (``by_design(narrow)``) equal raw to the
    wrapper's output; the wrapper's launch named by the design its lane
    count picks; then both designs timed in turns.  Logs the times, the
    narrow / wide ratio and the pick; raises where the wrapper takes narrow
    and narrow was the slower (a wide pick that loses is only logged: the
    thresholds sit where the two are close).  Returns (picked design, its
    mean ms)."""
    from bulletproofspp_tpu_torch.ops import kernels

    kernels.reset_counts()
    want = picked()
    (shape, n), = kernels.shape_counts()[name].items()
    design = shape.split()[-1]
    if shape != f"{label} {design}" or n != 1 or design not in ("narrow", "wide"):
        raise AssertionError(f"{name} {label}: the wrapper launched {kernels.shape_counts()[name]}")
    fns = {"narrow": lambda: by_design(True), "wide": lambda: by_design(False)}
    for d, fn in fns.items():
        same_raw(f"{name} {label} {d} against the wrapper's {design}", fn(), want)
    means, both = in_turns(fns, reps)
    faster = min(fns, key=means.get)
    log(f"{name} {label}: both designs equal raw; in turns (ms) {json.dumps(both)}; narrow / "
        f"wide {means['narrow'] / means['wide']:.4f}; the wrapper takes {design}"
        + ("" if design == faster else f" (NOT the faster here: {faster})"))
    if design == "narrow" != faster:
        raise AssertionError(f"{name} {label}: the wrapper takes the narrow design, the slower")
    return design, means[design]


def select_reduce_plain_by_msm(tables, absd, sgn, chunk: int = 26):
    """``select_reduce_plain`` run ``chunk`` MSMs at a time (the MSMs are
    independent: the same function), so that its memory stays bounded."""
    from bulletproofspp_tpu_torch.ops import kernels

    batch, _, L = absd.shape
    outs = []
    for b0 in range(0, batch, chunk):
        b1 = min(batch, b0 + chunk)
        tb = [t.view(t.shape[0], batch, L)[:, b0:b1].reshape(t.shape[0], -1) for t in tables]
        outs.append(kernels.select_reduce_plain(tb, absd[b0:b1], sgn[b0:b1]))
    return tuple(torch.cat(c, 1) for c in zip(*outs))


def check_padd(dev, rng):
    """Phase 2, padd: both designs at kernels.PADD_WIDTHS with
    P + Q, P + P and P + (-P) lanes and identity lanes, and every
    threads-a-block instantiation of the wide design at 65,536 lanes.
    Returns the rows at 1,056 lanes (the halving trees' commonest) and
    65,536 (the measurement path's)."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rows = []
    for L in kernels.PADD_WIDTHS:
        p, _ = random_points(L, rng, dev)
        mode = rng.integers(0, 3, size=L)  # 0: P + Q, 1: P + P, 2: P + (-P)
        q_other, _ = random_points(L, rng, dev)
        q_same = rescale_and_negate(p, rng, mode == 2)
        sel = torch.as_tensor(mode == 0, device=dev)
        q = tuple(torch.where(sel, a, b) for a, b in zip(q_other, q_same))
        err = compare(f"padd L={L}", kernels.padd(p, q), kernels.padd_plain(p, q))
        if L == MEASURE_L:
            for threads in kernels.PADD_THREADS:
                same_raw(f"padd L={L} threads={threads}", kernels.padd(p, q),
                         kernels.padd_design(p, q, False, threads))
        design, ms = designs_in_turns(
            "padd", f"L={L}", lambda narrow: kernels.padd_design(p, q, narrow),
            lambda: kernels.padd(p, q), 20 if L < MEASURE_L else 10)
        if L in (1056, MEASURE_L):
            rows.append(("padd", err, ms, time_ms(lambda: kernels.padd_plain(p, q), 3, paced=True),
                         f"L={L} {design}", bounds.padd(L), {"chain": bounds.padd_chain(design)}))
    log(f"padd L={MEASURE_L}: threads {kernels.PADD_THREADS} of the wide design equal raw")
    # what a launch costs with next to no work in it: the chain kernel's
    # one field addition a lane, at 16 lanes, back to back
    a, b = ([torch.as_tensor(rng.integers(0, 1 << 16, size=(16, 16)), device=dev)] * k
            for k in (1, 3))
    floor = time_ms(lambda: kernels.chain("add", a, b, 1), 20)
    log(f"launch floor: chain add, 1 step, L=16: {floor:.4f} ms a launch back to back")
    return rows


def check_table_flat(dev, rng):
    """Phase 2, table_flat: both designs at kernels.TABLE_FLAT_WIDTHS,
    about 1/8 identity lanes.  Returns the rows at 16 lanes (fold's tables,
    the main paths' commonest) and 4,096 (128by64's widest MSM)."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rows = []
    for L in kernels.TABLE_FLAT_WIDTHS:
        p = random_points(L, rng, dev)[0] if L <= 4096 else wide_points(L, rng, dev)
        tabs = kernels.table_flat(p)
        err = compare(f"table_flat L={L}", tabs, kernels.table_flat_plain(p))
        design, ms = designs_in_turns(
            "table_flat", f"L={L}", lambda narrow: kernels.table_flat_design(p, narrow),
            lambda: kernels.table_flat(p), 20 if L <= 4096 else 10)
        if L in (16, 4096):
            rows.append(("table_flat", err, ms,
                         time_ms(lambda: kernels.table_flat_plain(p), 2, paced=True),
                         f"L={L} {design}", bounds.table_flat(L),
                         {"chain": bounds.table_flat_chain(design)}))
    return rows


def reduce_block_plain_by_blocks(p, factor: int, chunk: int = 1 << 20):
    """``reduce_block_plain`` on ``chunk`` input lanes at a time (whole
    blocks of 128 * factor lanes, each narrowed on its own: the same
    function), so that its memory stays bounded at millions of lanes."""
    from bulletproofspp_tpu_torch.ops import kernels

    parts = [kernels.reduce_block_plain(tuple(t[:, a:a + chunk] for t in p), factor)
             for a in range(0, p[0].shape[1], chunk)]
    return tuple(torch.cat(c, 1) for c in zip(*parts))


def check_reduce_block(dev, rng):
    """Phase 2, reduce_block: both designs at kernels.REDUCE_BLOCK_WIDTHS
    (the main paths' (W, factor) launches), about 1/8 identity lanes, and in
    the first block P + P and P + (-P) at the first level.  Returns the rows
    at W = 33,792, f = 8 (the bench's second launch) and W = 16,896, f = 4
    (cli test's commonest)."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rows = []
    for w, f in kernels.REDUCE_BLOCK_WIDTHS:
        p = wide_points(w, rng, dev)
        half = 64 * f  # the first block's second half pairs with its first at level one
        twin = rescale_and_negate(tuple(c[:, :half] for c in p), rng, np.arange(half) % 2 == 1)
        for c, t in zip(p, twin):
            c[:, half:2 * half] = t
        err = compare(f"reduce_block W={w} f={f}", kernels.reduce_block(p, f),
                      reduce_block_plain_by_blocks(p, f))
        design, ms = designs_in_turns(
            "reduce_block", f"W={w} f={f}",
            lambda narrow: kernels.reduce_block_design(p, f, narrow),
            lambda: kernels.reduce_block(p, f), 10 if w < (1 << 20) else 4)
        if (w, f) in ((33792, 8), (16896, 4)):
            rows.append(("reduce_block", err, ms,
                         time_ms(lambda: kernels.reduce_block_plain(p, f), 2, paced=True),
                         f"W={w} f={f} {design}", bounds.reduce_block(w, f),
                         {"chain": bounds.reduce_block_chain(f, design == "narrow")}))
    return rows


def check_decompress(dev, rng):
    """Phase 2, decompress at 16 lanes (cli test's 32bit and 64bit), 64 and 16,384
    (the 1,024-proof batch's bucket): about 1/8 non-residue x's, random sign
    bits, and x = 0, 1 and p - 1 at 64; y and ok equal to the plain
    version's on every lane.  Returns the rows at 16 and 16,384 lanes."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.core.fields import Q
    from bulletproofspp_tpu_torch.ops import kernels, limb

    rows = []
    for L in (16, 64, DECOMPRESS_L):
        xs = residue_mix(L, rng)
        if L == 64:
            xs[:3] = [0, 1, Q - 1]
        x = limb.from_ints(xs, dev)
        sign = torch.as_tensor(rng.integers(0, 2, size=L), device=dev)
        (y, ok), (py, pok) = kernels.decompress(x, sign), kernels.decompress_plain(x, sign)
        err = max(int((y - py).abs().max().item()), int((ok != pok).sum().item()))
        if err != 0:
            raise AssertionError(f"kernel decompress L={L} disagrees with its plain version: {err}")
        log(f"decompress L={L}: {L - int(ok.sum().item())} non-residue lanes, y and ok equal to "
            "the plain version's")
        if L != 64:
            rows.append(("decompress", err, time_ms(lambda: kernels.decompress(x, sign), 10),
                         time_ms(lambda: kernels.decompress_plain(x, sign), 1, paced=True),
                         f"L={L}", bounds.decompress(L), {"products": bounds.decompress_chain()}))
    return rows


def check_kernels(dev):
    """Phase 2: each kernel against its plain version at the main path's shapes."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import glv, kernels, limb

    rng = np.random.default_rng(SEED)
    rows = check_padd(dev, rng)

    # horner: (16, K, 33) row sums for K stacked MSMs (msm_many: K up to 130),
    # with edge rows; word for word
    # (timed at K = 130 and at K = 1, the main paths' shape)
    sums = {K: horner_rows(K, rng, dev) for K in (1, 2, 130)}
    for K, r in sums.items():
        got, want = kernels.horner(*r), kernels.horner_plain(*r)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"horner K={K} differs from its plain version word for word")
        err = compare(f"horner K={K}", got, want)
    log("horner K=1, 2 and 130 with edge rows: equal to its plain version word for word")
    for K in (130, 1):
        r = sums[K]
        rows.append(("horner", err, time_ms(lambda: kernels.horner(*r), 5),
                     time_ms(lambda: kernels.horner_plain(*r), 1, paced=True),
                     f"K={K} rows={ROWS}", bounds.horner(K, ROWS)))

    rows += check_reduce_block(dev, rng)

    # tail_horner: (16, K, 33 * 128), K = 1, 3 and msm_many's 130, with an
    # all-identity row and a cancelling row in every MSM
    lanes = {K: tail_lanes(K, rng, dev) for K in (1, 3, 130)}
    for K, p in lanes.items():
        err = compare(f"tail_horner K={K}", kernels.tail_horner(p, ROWS),
                      kernels.tail_horner_plain(p, ROWS))
    log(f"tail_horner K=130 rows={ROWS}: max_abs_err {err}, cuda "
        f"{time_ms(lambda: kernels.tail_horner(p, ROWS), 5):.4f} ms")
    p1 = lanes[1]
    rows.append(("tail_horner", err, time_ms(lambda: kernels.tail_horner(p1, ROWS), 5),
                 time_ms(lambda: kernels.tail_horner_plain(p1, ROWS), 1, paced=True),
                 f"K=1 rows={ROWS}",
                 bounds.tail_horner(1, ROWS)))
    rows += check_table_flat(dev, rng)

    # select_reduce: a 4,096-lane MSM (128by64's widest), 33 rows
    L = 4096
    p, _ = random_points(L, rng, dev)
    tabs = kernels.table_flat(p)
    # select_reduce (also timed at L = 65,536 with the measurement kernels):
    # msm_many's 130 MSMs of 4,096 lanes (the staged design), three and one
    # (the gather), row 0 all zero digits with sign 1; each call must take
    # the design its lane count picks and equal the other design limb for
    # limb.  At B = 1 timed in turns with sr_variant (the same function on
    # the staged row phase)
    for batch in (130, 3, 1):
        absd = torch.as_tensor(rng.integers(0, 9, size=(batch, ROWS, L)), dtype=torch.uint8, device=dev)
        sgn = torch.as_tensor(rng.integers(0, 2, size=(batch, ROWS, L)), dtype=torch.uint8, device=dev)
        absd[:, 0], sgn[:, 0] = 0, 1
        tb = kernels.table_flat(wide_points(batch * L, rng, dev)) if batch > 1 else tabs
        staged = batch * L >= kernels.STAGE_MIN_LANES
        kernels.reset_counts()
        got = kernels.select_reduce(tb, absd, sgn)
        design = f"B={batch} L={L} {'staged' if staged else 'rows'}"
        if kernels.shape_counts()["select_reduce"] != {design: 1}:
            raise AssertionError(f"select_reduce did not launch as {design}: "
                                 f"{kernels.shape_counts()['select_reduce']}")
        err = compare(f"select_reduce B={batch} L={L}", got, select_reduce_plain_by_msm(tb, absd, sgn))
        if not all(torch.equal(a, b) for a, b in
                   zip(got, kernels.select_reduce_design(tb, absd, sgn, not staged))):
            raise AssertionError(f"select_reduce's two designs differ at B={batch} L={L}")
    same = kernels.sr_variant(tabs, absd[0], sgn[0], 1024, 128)
    if not all(torch.equal(a, b) for a, b in zip(same, kernels.select_reduce(tabs, absd, sgn))):
        raise AssertionError(f"sr_variant at blk 1,024 / out 128 differs from select_reduce, L={L}")
    means, both = in_turns({"select_reduce": lambda: kernels.select_reduce(tabs, absd, sgn),
                            "sr_variant": lambda: kernels.sr_variant(tabs, absd[0], sgn[0])}, 10)
    log(f"select_reduce L={L} rows={ROWS}: equal to its plain version and its other design (B = "
        f"130 staged, 3 and 1 the gather) and to sr_variant limb for limb; in turns select_reduce "
        f"{both['select_reduce']} ms, sr_variant (staged) {both['sr_variant']} ms")
    rows.append(("select_reduce", err, means["select_reduce"],
                 time_ms(lambda: kernels.select_reduce_plain(tabs, absd, sgn), 2, paced=True),
                 f"B=1 L={L} rows={ROWS}", bounds.select_reduce(absd, sgn)))

    # fold: per-lane b E + a O with shared digits, L = 512 (128by64's widest)
    # for the row; 16 and 520 lanes (not a multiple of a block's 4 warps)
    # with an identity lane, and rows of zero digits with sign 1
    b, a = (int(v) << 64 for v in rng.integers(1, 2**62, size=2))
    digits = np.stack([*glv.recode_signed(-b), *glv.recode_signed(a)])
    edge = digits.copy()
    edge[0, :3], edge[1, :3] = 0, 1
    edge[2, 5:9], edge[3, 5:9] = 0, 1
    for L, dig in ((16, edge), (520, edge), (512, digits)):
        pts = random_points(L, rng, dev)[0]
        for c, v in zip(pts, (0, 1, 0)):
            c[:, 0] = limb.from_ints([v], dev)[:, 0]
        e, o = kernels.table_flat(pts), kernels.table_flat(random_points(L, rng, dev)[0])
        err = compare(f"fold L={L}", kernels.fold(e, o, dig), kernels.fold_plain(e, o, dig))
    rows.append(("fold", err, time_ms(lambda: kernels.fold(e, o, digits), 10),
                 time_ms(lambda: kernels.fold_plain(e, o, digits), 1, paced=True), "L=512 rows=33",
                 bounds.fold(512, digits)))
    rows += check_fold_many(dev, rng)
    rows += check_fold_one(dev, rng)
    rows += check_complete_square(dev, rng)
    rows += check_fused(dev, rng)

    rows += check_decompress(dev, rng)
    rows += check_measurement_kernels(dev, rng)
    return kernel_rows(rows)


def kernel_rows(rows):
    """The kernel lines of the log and the rows of the kernel JSON line,
    {kernel: [row]}, from (name, max_abs_err, ms, plain ms, shape, work[,
    extra]) tuples: the bound at the card's maximum SM clock and the time
    per step of the kernel's longest dependent chain."""
    from bulletproofspp_tpu_torch import bounds

    torch.cuda.synchronize()
    mhz = bounds.card()["sm_clock_max_mhz"]
    # longest dependent chains (point ops, product rounds) at the rows' shapes
    chains = {"tail_horner": bounds.tail_horner_chain(ROWS), "horner": bounds.horner_chain(ROWS),
              "fold": bounds.fold_chain(ROWS),
              "select_reduce_fused": bounds.select_reduce_fused_chain(ROWS)}
    out = collections.defaultdict(list)
    for name, err, ms, plain_ms, shape, work, *extra in rows:
        extra = extra[0] if extra else {}
        bound_ms, bound_by = bounds.bound_sum(work if isinstance(work, list) else [work], mhz)
        library_ms = extra.get("library_ms")
        row = {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
               **{k: v for k, v in extra.items()
                  if k not in ("library_ms", "products", "batches", "chain")}}
        lib_s = f"  library {library_ms:.4f} ms" if library_ms is not None else ""
        chain_s = ""
        if "products" in extra:
            n = extra["products"]
            row["chain"] = {"products": n, "us_per_product": ms * 1e3 / n}
            chain_s = f"  chain {n} dependent field products ({ms * 1e3 / n:.3f} us each)"
        elif "batches" in extra:
            n = extra["batches"]
            row["chain"] = {"batches": n, "us_per_batch": ms * 1e3 / n}
            chain_s = f"  chain {n} divstep batches ({ms * 1e3 / n:.3f} us each)"
        elif name in chains or "chain" in extra:
            ops, rounds = extra.get("chain") or chains[name]
            row["chain"] = {"ops": ops, "rounds": rounds, "us_per_op": ms * 1e3 / ops,
                            "us_per_round": ms * 1e3 / rounds}
            chain_s = (f"  chain {ops} point ops ({ms * 1e3 / ops:.3f} us each), {rounds} product "
                       f"rounds ({ms * 1e3 / rounds:.3f} us each)")
        out[name].append(row)
        log(f"kernel {name:19s} {shape:28s} max_abs_err {err}  cuda {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}){lib_s}{chain_s}")
    log(f"bounds at the maximum SM clock of {mhz} MHz (nvidia-smi clocks.max.sm)")
    return out


def prover_digits(B: int, rng):
    """(B, 4, ROWS) fold digits, each prover's own scalars; prover 0's
    streams have rows of zero digits with sign 1."""
    from bulletproofspp_tpu_torch.ops import glv

    out = []
    for _ in range(B):
        b, a = (int(v) << 64 for v in rng.integers(1, 2**62, size=2))
        out.append(np.stack([*glv.recode_signed(-b), *glv.recode_signed(a)]))
    out[0][0, :3], out[0][1, :3] = 0, 1
    out[0][2, 5:9], out[0][3, 5:9] = 0, 1
    return np.stack(out)


def plain_once(fn):
    """One call of a plain version between two CUDA events: (ms, its output)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_fold_many(dev, rng):
    """Phase 2, fold_many at FOLD_MANY_CASES from the two bases' points: B
    provers' L lanes end to end (about 1/8 identity lanes), digits per
    prover (``prover_digits``); one launch of the group width its lanes
    pick and no table_flat launch; equal to its plain version after
    normalization, every group width (FOLD_MANY_GROUPS) equal raw to the
    wrapper's output, and at B = 1 (each case's first prover) equal word for
    word to table_flat + fold.  Timed: the group widths in turns (the sweep
    that set FOLD_MANY_WIDE_LANES; logged, with the fastest), then the
    wrapper in turns with the route it replaced on the same lanes (two
    table_flat launches over all B L lanes and B fold launches, which read
    the same tables as contiguous per-prover copies made beforehand).
    Returns a row for each case, with both timings."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rows = []
    for B, L in FOLD_MANY_CASES:
        pe, po = (random_points(B * L, rng, dev)[0] for _ in range(2))
        digits = prover_digits(B, rng)
        g = kernels.fold_many_group(B * L)
        kernels.reset_counts()
        got = kernels.fold_many(pe, po, digits)
        launched = {k: n for k, n in kernels.counts().items() if n}
        if (launched != {"fold_many": 1}
                or kernels.shape_counts()["fold_many"] != {f"B={B} L={L} G={g}": 1}):
            raise AssertionError(f"fold_many B={B} L={L} launched {kernels.shape_counts()}")
        plain_ms, want = plain_once(lambda: kernels.fold_many_plain(pe, po, digits))
        err = compare(f"fold_many B={B} L={L}", got, want)
        for group in kernels.FOLD_MANY_GROUPS:
            same_raw(f"fold_many B={B} L={L} G={group} against G={g}",
                     kernels.fold_many_design(pe, po, digits, group), got)
        first = [tuple(t[:, :L].contiguous() for t in p) for p in (pe, po)]
        same_raw(f"fold_many B=1 L={L} against table_flat + fold", kernels.fold_many(
            *first, digits[:1]), kernels.fold(*(kernels.table_flat(p) for p in first), digits[0]))
        groups, sweep = in_turns({f"G={group}": lambda group=group: kernels.fold_many_design(
            pe, po, digits, group) for group in kernels.FOLD_MANY_GROUPS}, 5)
        te, to = kernels.table_flat(pe), kernels.table_flat(po)
        per = [tuple(tuple(t[:, b * L:(b + 1) * L].contiguous() for t in tab) for tab in (te, to))
               for b in range(B)]
        means, both = in_turns({
            "fold_many": lambda: kernels.fold_many(pe, po, digits),
            "table_flat x 2 + B folds": lambda: (
                kernels.table_flat(pe), kernels.table_flat(po),
                [kernels.fold(e, o, d) for (e, o), d in zip(per, digits)])}, 5)
        fastest = min(groups, key=groups.get)
        log(f"fold_many B={B} L={L}: equal to its plain version, every group width equal raw, "
            f"and at B = 1 to table_flat + fold word for word; group widths in turns (ms) "
            f"{json.dumps(sweep)}, the wrapper takes G={g}"
            + ("" if fastest == f"G={g}" else f" (NOT the fastest here: {fastest})")
            + f"; in turns with the replaced route (ms) {json.dumps(both)}; fold_many / "
            f"replaced {means['fold_many'] / means['table_flat x 2 + B folds']:.4f}")
        rows.append(("fold_many", err, means["fold_many"], plain_ms,
                     f"B={B} L={L} G={g} rows={ROWS}", bounds.fold_many(B * L, digits),
                     {"chain": bounds.fold_many_chain(ROWS, g), "group_ms": groups,
                      "replaced_route_ms": means["table_flat x 2 + B folds"]}))
    return rows


def check_fold_one(dev, rng):
    """Phase 2, the one-prover fold at FOLD_ONE_LANES: fold_many at B = 1
    (``msm.fold_mul``'s launch) and its phi form (``kernels.fold_phi``,
    ``shared_mul``'s), each one fold_many launch and nothing else, equal word
    for word to the routes they replaced on the same lanes (table_flat x 2 +
    fold, and endo + table_flat x 2 + fold) and to their plain versions after
    normalization; each timed in turns with its replaced route.  Returns a
    row for each (lanes, form)."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rows = []
    for L in FOLD_ONE_LANES:
        pe, po = (random_points(L, rng, dev)[0] for _ in range(2))
        digits = prover_digits(1, rng)
        g = kernels.fold_many_group(L)
        forms = {
            "": (lambda: kernels.fold_many(pe, po, digits),
                 lambda: kernels.fold(kernels.table_flat(pe), kernels.table_flat(po), digits[0]),
                 lambda: kernels.fold_many_plain(pe, po, digits), "table_flat x 2 + fold",
                 bounds.fold_many(L, digits), bounds.fold_many_chain(ROWS, g)),
            " phi": (lambda: kernels.fold_phi(pe, digits),
                     lambda: kernels.fold(kernels.table_flat(pe),
                                          kernels.table_flat(kernels.endo(pe)), digits[0]),
                     lambda: kernels.fold_phi_plain(pe, digits), "endo + table_flat x 2 + fold",
                     bounds.fold_phi(L, digits), bounds.fold_phi_chain(ROWS, g)),
        }
        for form, (fn, route, plain, route_name, work, chain) in forms.items():
            shape = f"B=1 L={L} G={g}{form}"
            kernels.reset_counts()
            got = fn()
            launched = {k: v for k, v in kernels.shape_counts().items() if v}
            if launched != {"fold_many": {shape: 1}}:
                raise AssertionError(f"fold_many {shape} launched {launched}")
            same_raw(f"fold_many {shape} against {route_name}", got, route())
            plain_ms, want = plain_once(plain)
            err = compare(f"fold_many {shape}", got, want)
            means, both = in_turns({"fold_many": fn, route_name: route}, 5)
            log(f"fold_many {shape}: one launch, equal word for word to {route_name} and to its "
                f"plain version after normalization; in turns with that route (ms) "
                f"{json.dumps(both)}; fold_many / route "
                f"{means['fold_many'] / means[route_name]:.4f}")
            rows.append(("fold_many", err, means["fold_many"], plain_ms, f"{shape} rows={ROWS}",
                         work, {"chain": chain, "replaced_route_ms": means[route_name]}))
    return rows


def check_complete_square(dev, rng):
    """Phase 2, complete_square at CSQ_CASES: g0 and g1 of B provers' L lanes
    end to end (about 1/8 identity lanes), digits per prover
    (``prover_digits``); exactly one launch, of the group width its lanes
    pick, and no endo, pneg, padd, table_flat, fold or fold_many launch;
    (gx, hy) equal word for word to the unfused route (endo, fold_many,
    padd(g1, rp), pneg, padd(g1, -rp)) and to its plain version after
    normalization.  Timed in turns with the unfused route on the same
    inputs.  Returns a row for each case."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    def unfused(g0, g1, digits):
        rp = kernels.fold_many(g0, kernels.endo(g0), digits)
        return kernels.padd(g1, rp), kernels.padd(g1, kernels.pneg(rp))

    rows = []
    for B, L in CSQ_CASES:
        g0, g1 = (random_points(B * L, rng, dev)[0] for _ in range(2))
        digits = prover_digits(B, rng)
        g = kernels.fold_many_group(B * L)
        kernels.reset_counts()
        gx, hy = kernels.complete_square(g0, g1, digits)
        launched = {k: n for k, n in kernels.counts().items() if n}
        if (launched != {"complete_square": 1} or kernels.shape_counts()["complete_square"]
                != {f"B={B} L={L} G={g}": 1}):
            raise AssertionError(f"complete_square B={B} L={L} launched {kernels.shape_counts()}")
        ux, uy = unfused(g0, g1, digits)
        same_raw(f"complete_square B={B} L={L} gx against the unfused route", gx, ux)
        same_raw(f"complete_square B={B} L={L} hy against the unfused route", hy, uy)
        plain_ms, want = plain_once(lambda: kernels.complete_square_plain(g0, g1, digits))
        err = max(compare(f"complete_square B={B} L={L} gx", gx, want[0]),
                  compare(f"complete_square B={B} L={L} hy", hy, want[1]))
        means, both = in_turns({"complete_square": lambda: kernels.complete_square(g0, g1, digits),
                                "unfused": lambda: unfused(g0, g1, digits)}, 5)
        log(f"complete_square B={B} L={L} G={g}: one launch, equal word for word to endo + "
            f"fold_many + padd + pneg + padd and to its plain version after normalization; in "
            f"turns with that route (ms) {json.dumps(both)}; fused / unfused "
            f"{means['complete_square'] / means['unfused']:.4f}")
        rows.append(("complete_square", err, means["complete_square"], plain_ms,
                     f"B={B} L={L} G={g} rows={ROWS}", bounds.complete_square(B * L, digits),
                     {"chain": bounds.complete_square_chain(ROWS, g),
                      "unfused_route_ms": means["unfused"]}))
    return rows


def check_measurement_kernels(dev, rng):
    """Phase 2, the measurement path's kernels at L = 65,536: sr_variant for
    every (blk, out_w) of the r5 tool and noselect, grid_copy, and chain for
    all ten phases, against their plain versions (max |diff| 0: normalized
    for the value phases, raw limbs for the limb-form ones)."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels, limb

    L = MEASURE_L
    p, _ = random_points(L, rng, dev)
    tabs = kernels.table_flat(p)
    absd = torch.as_tensor(rng.integers(0, 9, size=(ROWS, L)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(ROWS, L)), dtype=torch.uint8, device=dev)
    for blk, out_w, noselect in SR_CASES:
        err = compare(f"sr_variant blk={blk} out={out_w} noselect={noselect}",
                      kernels.sr_variant(tabs, absd, sgn, blk, out_w, noselect),
                      kernels.sr_variant_plain(tabs, absd, sgn, blk, out_w, noselect))
    sr_err = err
    # select_reduce at the bench's shape (its staged design); its gather
    # design and sr_variant at blk 1,024 / out 128 compute the same function:
    # all three equal limb for limb
    ad, sg = absd[None], sgn[None]
    ref = kernels.select_reduce(tabs, ad, sg)
    err = compare(f"select_reduce L={L}", ref, kernels.select_reduce_plain(tabs, ad, sg))
    for name, got in (("sr_variant", kernels.sr_variant(tabs, absd, sgn, 1024, 128)),
                      ("the rows design", kernels.select_reduce_design(tabs, ad, sg, False))):
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name} differs from select_reduce at L={L}")
    log(f"sr_variant L={L} rows={ROWS}: {len(SR_CASES)} (blk, out_w, noselect) cases equal to "
        "their plain versions; select_reduce equal to its plain version, and sr_variant at blk "
        "1,024 / out 128 and select_reduce's rows design equal to it limb for limb")
    means, both = in_turns({
        "select_reduce": lambda: kernels.select_reduce(tabs, ad, sg),
        "sr_variant": lambda: kernels.sr_variant(tabs, absd, sgn, 1024, 128),
        "noselect": lambda: kernels.sr_variant(tabs, absd, sgn, 1024, 128, True),
        "rows design": lambda: kernels.select_reduce_design(tabs, ad, sg, False)}, 10)
    log(f"select_reduce L={L} rows={ROWS} in turns (ms): {json.dumps(both)}; select_reduce / "
        f"sr_variant {means['select_reduce'] / means['sr_variant']:.4f}")
    rows = [("select_reduce", err, means["select_reduce"],
             time_ms(lambda: kernels.select_reduce_plain(tabs, ad, sg), 1, paced=True),
             f"B=1 L={L} rows={ROWS}", bounds.select_reduce(ad, sg)),
            ("sr_variant", sr_err, means["sr_variant"],
             time_ms(lambda: kernels.sr_variant_plain(tabs, absd, sgn, 1024, 128), 1, paced=True),
             f"L={L} rows={ROWS} blk=1024 out=128", bounds.sr_variant(absd, sgn, 1024, 128, False))]

    x = torch.as_tensor(rng.integers(0, 1 << 16, size=(16, L)), device=dev)
    x[:, :7] = 0xFFFFFFFF  # (x + 1) wraps mod 2^32
    got, want = kernels.grid_copy(x), kernels.grid_copy_plain(x)
    err = int((got - want).abs().max().item())
    if err != 0:
        raise AssertionError(f"kernel grid_copy disagrees with its plain version: {err}")
    # the kernel and its library call in turns
    means, both = in_turns({"kernel": lambda: kernels.grid_copy(x),
                            "library": lambda: (x + 1).repeat(1, ROWS)}, 20)
    log(f"grid_copy L={L} rows={ROWS} in turns: kernel {both['kernel']} ms, library "
        f"{both['library']} ms")
    rows.append(("grid_copy", err, means["kernel"],
                 time_ms(lambda: kernels.grid_copy_plain(x), 5, paced=True), f"L={L} rows={ROWS}",
                 bounds.grid_copy(L, ROWS), {"library_ms": means["library"]}))

    # chain: random limbs with edge_planes lanes first (every phase's state
    # and operands rotated apart, so edge values meet each other); the
    # value phases normalized against their plain versions, the limb-form
    # ones raw, and the phases that are one field.cuh function (mul_f16,
    # add, sub) raw against its representative (kernels.field_words)
    ms = plain_ms = 0.0
    works = []
    words = {"mul_f16": "mul", "add": "add", "sub": "sub"}
    for phase, (_, nstate, value) in kernels.CHAIN_PHASES.items():
        a = tuple(edge_planes(L, rng, dev, s) for s in (0, 5, 3)[:nstate])
        b = tuple(edge_planes(L, rng, dev, s) for s in (7, 2, 9))
        for rep in (1, 8):
            got, want = kernels.chain(phase, a, b, rep), kernels.chain_plain(phase, a, b, rep)
            if phase in words:
                model = a[0]
                for _ in range(rep):
                    model = kernels.field_words(words[phase], model, b[0])
                same_raw(f"chain {phase} rep={rep} against field_words", (got,), (model,))
            if value:
                got, want = limb.normalize(got), limb.normalize(want)
            err = int((got - want).abs().max().item())
            if err != 0:
                raise AssertionError(f"kernel chain {phase} rep={rep} disagrees with its plain "
                                     f"version: max |diff| {err}")
        ms += time_ms(lambda: kernels.chain(phase, a, b, 8), 5)
        plain_ms += time_ms(lambda: kernels.chain_plain(phase, a, b, 8), 1, paced=True)
        works.append(bounds.chain(phase, L, 8))
    log(f"chain L={L}, edge lanes: all ten phases equal to their plain versions, 1 and 8 steps; "
        "mul_f16, add and sub equal raw to field.cuh's representative (kernels.field_words)")
    # ten launches: the bound is the sum of each phase's own
    rows.append(("chain", 0, ms, plain_ms, f"L={L} rep=8, 10 phases summed", works))
    # chain's round phases (kernels.ROUND_PHASES: the point chains' rounds,
    # fold_rows' among them, a lane on 16 threads) at ROUND_LANES lanes with
    # edge lanes, 1 and 8 steps, against their plain versions; phase_bench
    # (phase 8) times them on one warp
    for phase in kernels.ROUND_PHASES:
        a = tuple(edge_planes(ROUND_LANES, rng, dev, sh) for sh in (0, 5, 3))
        b = tuple(edge_planes(ROUND_LANES, rng, dev, sh) for sh in (7, 2, 9))
        for rep in (1, 8):
            got = limb.normalize(kernels.round_chain(phase, a, b, rep))
            want = limb.normalize(kernels.round_chain_plain(phase, a, b, rep))
            if not torch.equal(got, want):
                raise AssertionError(f"chain's round phase {phase} rep={rep} disagrees with its "
                                     "plain version")
    log(f"chain's round phases {sorted(kernels.ROUND_PHASES)} at {ROUND_LANES} lanes, edge lanes: "
        "equal to their plain versions after normalization, 1 and 8 steps")
    return rows


def select_reduce_fused_plain_by_rows(p, absd, sgn, chunk: int = 3):
    """``select_reduce_fused_plain`` for one MSM, the tables built once and
    the rows selected and narrowed ``chunk`` at a time (the rows are
    independent and the partials row-major: the same function), so that
    its memory stays bounded at 2^21 lanes."""
    from bulletproofspp_tpu_torch.ops import kernels

    tables = kernels.table_flat_plain(p)
    parts = [kernels.select_reduce_plain(tables, absd[:, r:r + chunk], sgn[:, r:r + chunk])
             for r in range(0, absd.shape[1], chunk)]
    return tuple(torch.cat(c, 1) for c in zip(*parts))


def check_fused(dev, rng):
    """select_reduce_fused with a row of zero digits and sign 1 and about
    1/8 identity lanes, equal limb for limb (raw) to table_flat +
    select_reduce on the same inputs, both routes timed in turns and the
    peak device memory each allocates above its inputs (and above what is
    held for the comparison) logged, and equal after normalization to its
    plain version: at 4,096 lanes, and at 2^21 lanes, its route, where the
    plain version runs a few rows at a time.  Returns a row for each."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    out = []
    for L in (4096, WIDE_LANES):
        p = random_points(L, rng, dev)[0] if L == 4096 else wide_points(L, rng, dev)
        absd = torch.as_tensor(rng.integers(0, 9, size=(1, ROWS, L)), dtype=torch.uint8, device=dev)
        sgn = torch.as_tensor(rng.integers(0, 2, size=(1, ROWS, L)), dtype=torch.uint8, device=dev)
        absd[:, 3], sgn[:, 3] = 0, 1
        routes = {"fused": lambda: kernels.select_reduce_fused(p, absd, sgn),
                  "table_flat + select_reduce":
                      lambda: kernels.select_reduce(kernels.table_flat(p), absd, sgn)}
        inputs = sum(t.numel() * t.element_size() for t in (*p, absd, sgn)) / 2**30
        peaks = {}
        for name, fn in routes.items():
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = fn()
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - held) / 2**30
            if name == "fused":
                fused = got
                continue
            raw = max(int((a - b).abs().max().item()) for a, b in zip(fused, got))
            if raw != 0:
                raise AssertionError(f"select_reduce_fused differs from table_flat + "
                                     f"select_reduce at L={L}: max |diff| {raw} (raw limbs)")
        del got
        means, both = in_turns(routes, 3 if L == WIDE_LANES else 10)
        log(f"select_reduce_fused L={L} rows={ROWS}: equal limb for limb to table_flat + "
            f"select_reduce; in turns (ms) {json.dumps(both)}; fused / two kernels "
            f"{means['fused'] / means['table_flat + select_reduce']:.4f}; peak device memory "
            f"above the inputs ({inputs:.2f} GiB), by route (GiB) {json.dumps(peaks)}")
        if L == 4096:
            plain = lambda: kernels.select_reduce_fused_plain(p, absd, sgn)  # noqa: E731
            plain_reps = 2
        else:
            plain = lambda: select_reduce_fused_plain_by_rows(p, absd, sgn)  # noqa: E731
            plain_reps = 1
        err = compare(f"select_reduce_fused L={L}", fused, plain())
        out.append(("select_reduce_fused", err, means["fused"],
                    time_ms(plain, plain_reps, paced=True), f"L={L} rows={ROWS}",
                    bounds.select_reduce_fused(absd, sgn)))
        del fused
    return out


def sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_cli(args) -> int:
    from bulletproofspp_tpu_torch import cli

    rc = cli.main(list(args) + ["--device", DEVICE])
    torch.cuda.synchronize()
    return rc


def main_path(work):
    """Phase 3: the CLI's test command on every example, golden bytes.
    Returns each example's launches {example: {kernel: launches}}."""
    from bulletproofspp_tpu_torch.ops import kernels

    secs, by_example = {}, {}
    for name, (want_proof, want_coms) in golden().items():
        before = kernels.counts()
        d = os.path.join(work, name)
        os.makedirs(d)
        for f in ("schema.json", "witness.json"):
            shutil.copy(os.path.join(HERE, "examples", name, f), d)
        os.chdir(d)
        t0 = time.perf_counter()
        rc = run_cli(["test", "schema.json", "witness.json", "commits.bin", "proof.bin"])
        secs[name] = time.perf_counter() - t0
        by_example[name] = {k: n - before[k] for k, n in kernels.counts().items()}
        if rc != 0:
            raise AssertionError(f"{name}: cli test rc {rc}")
        if (sha("proof.bin"), sha("commits.bin")) != (want_proof, want_coms):
            raise AssertionError(f"{name}: proof/commitment bytes differ from the golden digests")
        log(f"main path {name}: cli test rc 0, golden bytes, {secs[name]:.3f} s")
    os.chdir(work)
    return by_example


def prove_verify_times(work):
    """Phase 5: prove and verify seconds per example; a flipped byte fails."""
    for name, (want_proof, _) in golden().items():
        os.chdir(os.path.join(work, name))
        t0 = time.perf_counter()
        rc = run_cli(["prove", "schema.json", "witness.json", "c2.bin", "p2.bin"])
        t_prove = time.perf_counter() - t0
        if rc != 0 or sha("p2.bin") != want_proof:
            raise AssertionError(f"{name}: prove rc {rc} or bytes differ")
        t0 = time.perf_counter()
        rc = run_cli(["verify", "schema.json", "c2.bin", "p2.bin"])
        t_verify = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: verify rc {rc}")
        bad = bytearray(open("p2.bin", "rb").read())
        bad[31] ^= 1
        with open("bad.bin", "wb") as f:
            f.write(bytes(bad))
        rc = run_cli(["verify", "schema.json", "c2.bin", "bad.bin"])
        if rc != 1:
            raise AssertionError(f"{name}: tampered proof gave rc {rc}, want 1")
        log(f"{name}: prove {t_prove:.3f} s, verify {t_verify:.3f} s, tampered proof rejected (rc 1)")
    os.chdir(work)


def require_launched(path, launches, names):
    idle = sorted(k for k in names if launches[k] == 0)
    if idle:
        raise AssertionError(f"kernels never launched on {path}: {idle}")


def require_none(path, by_shape, names):
    """Raises if a kernel of ``names`` launched on the path ({kernel: {shape:
    launches}})."""
    busy = {k: sum(by_shape[k].values()) for k in names if sum(by_shape[k].values())}
    if busy:
        raise AssertionError(f"{path} launched {busy}")


def msm_wide(dev):
    """Phase 6: one MSM of 2^20 pairs, a bucket of exactly 2^21 GLV lanes."""
    from bulletproofspp_tpu_torch import dryrun
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    n = WIDE_LANES // 2
    pairs, want = dryrun.msm_case(n, SEED + 6)
    eng = TorchEngine(dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    t0 = time.perf_counter()
    got = eng.msm(pairs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernels.counts()
    if got != want:
        raise AssertionError("the 2^21-lane MSM differs from the host-integer answer")
    require_launched("the 2^21-lane MSM", launches, {"select_reduce_fused"})
    if launches["select_reduce"] or launches["table_flat"]:
        raise AssertionError(f"the 2^21-lane MSM built flat tables: {launches}")
    log(f"msm of {n} pairs ({2 * n} lanes): equal to the host-integer answer, {secs:.3f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    shapes = kernels.shape_counts()
    from torch.profiler import ProfilerActivity, profile

    from bulletproofspp_tpu_torch import engine_profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.msm(pairs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    device_s, top = engine_profile.device_time(prof)
    log(f"msm of {n} pairs under torch.profiler: {secs:.3f} s wall, {device_s:.4f} s of device "
        f"time, by kernel (ms, launches) {json.dumps(top)}")
    return shapes


def batch_1024(dev, work):
    """Phase 7: prove 1,024 proofs on the card, batch-verify them through the
    port's CLI, reject a flipped byte, and find the bad proof.  Returns the
    launches by shape of the valid batch-verify and the proofs' bytes."""
    from bulletproofspp_tpu_torch import engine_profile
    from bulletproofspp_tpu_torch.core.batch import verify_many_encoded
    from bulletproofspp_tpu_torch.core.engine import HostEngine
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    n, bad = BATCH_N, BATCH_BAD
    secs = {}
    t0 = time.perf_counter()
    setup, blobs = engine_profile.batch_proofs(range(n), TorchEngine(dev))
    secs[f"prove {n} (TorchEngine)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if engine_profile.batch_proofs([0, n - 1], HostEngine())[1] != [blobs[0], blobs[n - 1]]:
        raise AssertionError(f"proofs 0 and {n - 1} differ from HostEngine's bytes")
    secs[f"prove 0 and {n - 1} (HostEngine)"] = time.perf_counter() - t0

    d = os.path.join(work, "batch")
    os.makedirs(d)
    files = []
    for i, (coms_b, proof_b) in enumerate(blobs):
        for kind, data in (("coms", coms_b), ("proof", proof_b)):
            files.append(os.path.join(d, f"{kind}{i}.bin"))
            with open(files[-1], "wb") as f:
                f.write(data)
    flipped = bytearray(blobs[bad][1])
    flipped[31] ^= 1
    with open(os.path.join(d, "proof_bad.bin"), "wb") as f:
        f.write(bytes(flipped))
    schema = os.path.join(HERE, "examples", "64bit", "schema.json")

    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = run_cli(["batch-verify", schema, *files])
    secs[f"cli batch-verify, {n} valid"] = time.perf_counter() - t0
    launches, shapes = kernels.counts(), kernels.shape_counts()
    if rc != 0:
        raise AssertionError(f"batch-verify of {n} valid proofs gave rc {rc}")
    require_launched("batch-verify", launches,
                     {"decompress", "table_flat", "select_reduce", "reduce_block", "tail_horner"})
    t0 = time.perf_counter()
    bad_files = list(files)
    bad_files[2 * bad + 1] = os.path.join(d, "proof_bad.bin")
    rc = run_cli(["batch-verify", schema, *bad_files])
    secs[f"cli batch-verify, proof {bad} flipped"] = time.perf_counter() - t0
    if rc != 1:
        raise AssertionError(f"batch-verify with a flipped byte gave rc {rc}, want 1")
    t0 = time.perf_counter()
    entries = [(setup, c, p) for c, p in blobs]
    entries[bad] = (setup, blobs[bad][0], bytes(flipped))
    verdicts = verify_many_encoded(entries, TorchEngine(dev))
    torch.cuda.synchronize()
    secs[f"verify_many_encoded, proof {bad} flipped"] = time.perf_counter() - t0
    if verdicts != [i != bad for i in range(n)]:
        raise AssertionError(f"verify_many_encoded flagged {[i for i, v in enumerate(verdicts) if not v]}")

    row = next(engine_profile.run_batch(setup, blobs, engine_profile.TimedEngine(dev), 1))
    log(f"batch of {n}: {row['decompressed_points']} points decompressed, merged MSM of "
        f"{row['msm_points']} points in a bucket of {row['msm_lanes']} lanes; "
        f"launches during the valid batch-verify {launches}")
    for step, t in secs.items():
        log(f"batch step {step}: {t:.3f} s")
    log(f"batch_verify_encoded by engine call: {json.dumps(row)}")
    return shapes, blobs


def example_files(name):
    return tuple(os.path.join(HERE, "examples", name, f) for f in ("schema.json", "witness.json"))


def prove_batch_phase(dev, work):
    """Phase 9: the CLI's prove-batch over PROVE_BATCH, against proving one
    at a time.  Returns the launches by shape of the CLI run and {item:
    (name, seed, commitment bytes, proof bytes)}."""
    from bulletproofspp_tpu_torch import cli, engine_profile
    from bulletproofspp_tpu_torch.core import range_proof as rpm
    from bulletproofspp_tpu_torch.core.engine import HostEngine
    from bulletproofspp_tpu_torch.core.lockstep import prove_many
    from bulletproofspp_tpu_torch.io_ import schema as schema_mod
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    names = [name for name, k in PROVE_BATCH for _ in range(k)]
    out = os.path.join(work, "prove_batch")
    kernels.reset_counts()
    t0 = time.perf_counter()
    rc = run_cli(["prove-batch", *(f for n in names for f in example_files(n)), "--out-dir", out])
    batch_s = time.perf_counter() - t0
    launches, shapes = kernels.counts(), kernels.shape_counts()
    if rc != 0:
        raise AssertionError(f"prove-batch rc {rc}")
    if not any(s.startswith("B=16 ") for s in shapes["fold_many"]):
        raise AssertionError(f"prove-batch launched no 16-prover fold_many: {shapes['fold_many']}")
    setups = {}
    for name in set(names):
        spec_path, wit_path = example_files(name)
        with open(spec_path) as f:
            spec = schema_mod.parse_spec(json.load(f))
        setup = schema_mod.build_setup(spec, cli.load_points(spec, schema_mod.points_needed(spec)))
        with open(wit_path) as f:
            values = cli._resolve_values(spec, schema_mod.parse_witness(json.load(f)))
        setups[name] = (spec, setup, values)
    eng = TorchEngine(dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    items = {}
    for i, name in enumerate(names):
        spec, setup, values = setups[name]
        seed = f"{spec.random_seed}#{i}".encode()
        blobs = rpm.encode_proof(setup, rpm.prove(setup, values, seed, eng))
        torch.cuda.synchronize()
        with open(os.path.join(out, f"commits_{i}.bin"), "rb") as f, \
                open(os.path.join(out, f"proof_{i}.bin"), "rb") as g:
            if (f.read(), g.read()) != blobs:
                raise AssertionError(f"prove-batch item {i} ({name}) differs from proving it alone")
        items[i] = (name, seed, *blobs)
    seq_s = time.perf_counter() - t0
    seq = kernels.counts()
    # the same proofs through prove_many in this process, setups built (the
    # CLI's wall time above also holds its setups, file reads and writes)
    triples = [(setups[name][1], setups[name][2], seed) for name, seed, *_ in items.values()]
    t0 = time.perf_counter()
    fused = prove_many(triples, eng)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    if [rpm.encode_proof(s, p) for (s, _v, _s), p in zip(triples, fused)] != \
            [tuple(item[2:]) for item in items.values()]:
        raise AssertionError("prove_many's proofs differ from the CLI's")
    for i in (0, 16):  # a 64bit and a 32bit proof
        name, seed, coms_b, proof_b = items[i]
        _, setup, values = setups[name]
        if rpm.encode_proof(setup, rpm.prove(setup, values, seed, HostEngine())) != (coms_b, proof_b):
            raise AssertionError(f"prove-batch item {i} ({name}) differs from HostEngine's bytes")
    for i, (name, _seed, coms_b, proof_b) in items.items():
        setup = setups[name][1]
        if not rpm.verify(setup, rpm.decode_proof(setup, coms_b, proof_b, engine=eng), eng):
            raise AssertionError(f"prove-batch item {i} ({name}) does not verify")
    log(f"prove-batch of {len(names)} ({', '.join(f'{k} x {n}' for n, k in PROVE_BATCH)}): equal "
        f"byte for byte to proving one at a time (items 0 and 16 also to HostEngine's), every "
        f"proof verifies; wall {batch_s:.3f} s (the CLI, setups and files included); the same "
        f"proofs in this process {fused_s:.3f} s through prove_many, {seq_s:.3f} s one at a time; fold "
        f"launches: prove-batch fold {launches['fold']}, fold_many {launches['fold_many']} "
        f"{json.dumps(shapes['fold_many'])}; one at a time fold {seq['fold']}, fold_many "
        f"{seq['fold_many']}")
    log(f"lockstep profile: {json.dumps(engine_profile.profile_lockstep(16, TorchEngine(dev)))}")
    return shapes, items


def serve_phase(dev, items):
    """Phase 10: the proof service in this process, then the CLI's serve as
    a subprocess.  Returns the launches by shape of the served requests."""
    from bulletproofspp_tpu_torch import serve
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    objs = {}
    for name in ("64bit", "128by64"):
        objs[name] = []
        for path in example_files(name):
            with open(path) as f:
                objs[name].append(json.load(f))
    proves = [i for i, (name, *_) in items.items() if name in objs]
    flipped = bytearray(items[8][3])
    flipped[31] ^= 1
    reqs = [{"id": i, "op": "prove", "schema": objs[items[i][0]][0],
             "witness": objs[items[i][0]][1], "seed": items[i][1].hex()} for i in proves]
    reqs += [{"id": f"v{i}", "op": "verify", "schema": objs["64bit"][0],
              "commits": items[i][2].hex(), "proof": items[i][3].hex()} for i in range(8)]
    reqs += [{"id": "flipped", "op": "verify", "schema": objs["64bit"][0],
              "commits": items[8][2].hex(), "proof": bytes(flipped).hex()},
             {"id": "malformed", "op": "prove", "schema": objs["64bit"][0], "witness": []}]
    with serve.ProofServer(port=0, engine=TorchEngine(dev), linger_ms=500) as srv:
        t0 = time.perf_counter()
        srv.service.warm([tuple(objs["64bit"])], sizes=(1, 2, 4, 8, 16))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        kernels.reset_counts()
        t0 = time.perf_counter()
        resps = serve.request("127.0.0.1", srv.port, reqs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        shapes = kernels.shape_counts()
        stats = serve.request("127.0.0.1", srv.port, [{"op": "stats"}])[0]
    got = {r["id"]: r for r in resps}
    for i in proves:
        r = got[i]
        if not r["ok"] or (bytes.fromhex(r["commits"]), bytes.fromhex(r["proof"])) != items[i][2:]:
            raise AssertionError(f"served proof {i} ({items[i][0]}) differs from phase 9's bytes")
    if [got[f"v{i}"].get("valid") for i in range(8)] != [True] * 8:
        raise AssertionError(f"a served verify of a valid proof failed: {resps}")
    if got["flipped"] != {"id": "flipped", "ok": True, "valid": False}:
        raise AssertionError(f"the flipped proof answered {got['flipped']}")
    if got["malformed"]["ok"] is not False:
        raise AssertionError(f"the malformed request answered {got['malformed']}")
    if (stats["proved"], stats["verified"]) != (len(proves), 9):
        raise AssertionError(f"stats: {stats}")
    if not any(s.startswith("B=16 ") for s in shapes["fold_many"]):
        raise AssertionError(f"the service launched no 16-prover fold_many: {shapes['fold_many']}")
    log(f"serve: warm (64bit, sizes 1-16) {warm_s:.3f} s; {len(reqs)} pipelined requests "
        f"answered in {secs:.3f} s ({len(proves)} proves equal to phase 9's bytes, 8 valid, the "
        f"flipped one not, the malformed one ok false); stats {json.dumps(stats)}; fold_many "
        f"{json.dumps(shapes['fold_many'])}")

    proc = subprocess.Popen([sys.executable, "-m", "bulletproofspp_tpu_torch.cli", "serve",
                             "--port", "0", "--device", "cuda"], cwd=HERE,
                            stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        if not line.startswith("serving on "):
            raise AssertionError(f"cli serve printed {line!r}")
        host, port = line.split()[-1].rsplit(":", 1)
        [r] = serve.request(host, int(port), [reqs[len(proves)]])
        if r != {"id": "v0", "ok": True, "valid": True}:
            raise AssertionError(f"cli serve answered {r}")
        log(f"cli serve: {line.strip()}, answered a verify, {time.perf_counter() - t0:.3f} s")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return shapes


def cli_output(args):
    """``run_cli`` with what the CLI prints captured (and logged): (rc, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_cli(args)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    return rc, out


def verify_elsewhere(spec, coms, proof) -> int:
    """The port's CLI ``verify`` in a process of its own: its exit code."""
    res = subprocess.run([sys.executable, "-m", "bulletproofspp_tpu_torch.cli", "verify", spec,
                          coms, proof, "--device", DEVICE],
                         cwd=HERE, capture_output=True, text=True, timeout=300)
    if res.returncode not in (0, 1):
        log(res.stdout + res.stderr)
    return res.returncode


def mp_prove_checked(name, parties, work, label, extra=()):
    """The CLI's mp-prove of example ``name`` over ``parties`` parties (its
    own options ``extra``): rc 0 and "...: True", the files accepted by the
    CLI's verify in this process and in another, and with one byte of the
    proof flipped rejected (rc 1) in another.  Returns its wall seconds."""
    spec, wit = example_files(name)
    coms, proof = (os.path.join(work, f"mp_{label}_{f}.bin") for f in ("commits", "proof"))
    t0 = time.perf_counter()
    rc, out = cli_output(["mp-prove", spec, wit, coms, proof, "--parties", str(parties), *extra])
    secs = time.perf_counter() - t0
    mode = "threads" if "--local" in extra else f"{parties} TCP subprocesses"
    if rc != 0 or f"Multiparty range proof ({mode}): True" not in out:
        raise AssertionError(f"mp-prove {name} ({label}) rc {rc}: {out!r}")
    if run_cli(["verify", spec, coms, proof]) != 0:
        raise AssertionError(f"mp-prove {name} ({label}): the CLI's verify rejected its files")
    if verify_elsewhere(spec, coms, proof) != 0:
        raise AssertionError(f"mp-prove {name} ({label}): verify in another process rejected "
                             "its files")
    bad = bytearray(open(proof, "rb").read())
    bad[31] ^= 1
    with open(proof + ".flipped", "wb") as f:
        f.write(bytes(bad))
    if verify_elsewhere(spec, coms, proof + ".flipped") != 1:
        raise AssertionError(f"mp-prove {name} ({label}): a flipped byte was not rejected (rc 1)")
    log(f"mp-prove {name} over {parties} parties ({label}): rc 0, True, {secs:.3f} s of wall; "
        "verify accepts its files here and in another process, rejects a flipped byte (rc 1)")
    return secs


def affine_walk(n: int, seed: int):
    """n distinct affine points (a random start, then a random step added
    lane by lane), every 7th lane (from lane 3) None."""
    from bulletproofspp_tpu_torch.core import ec
    from bulletproofspp_tpu_torch.core.fields import R

    rng = np.random.default_rng(seed)
    p = ec.scalar_mul(int.from_bytes(rng.bytes(32), "little") % R, ec.G)
    step = ec.scalar_mul(int.from_bytes(rng.bytes(32), "little") % R, ec.G)
    out = []
    for i in range(n):
        out.append(None if i % 7 == 3 else p)
        p = ec.add(p, step)
    return out


def engine_interface(dev):
    """Phase 11 (e): fold_bases and shared_mul on the card at MP_LANES,
    equal to HostEngine's (None lanes; zero scalars), each call through one
    to_affine launch."""
    from bulletproofspp_tpu_torch.core.engine import HostEngine
    from bulletproofspp_tpu_torch.core.fields import R
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    eng, host = TorchEngine(dev), HostEngine()
    rng = np.random.default_rng(SEED + 11)

    def one_to_affine(call, *args):
        before = kernels.counts()
        out = getattr(eng, call)(*args)
        made = {k: n - before[k] for k, n in kernels.counts().items() if n != before[k]}
        if made != {"fold_many": 1, "to_affine": 1}:
            raise AssertionError(f"{call} launched {made}, not one fold_many and one to_affine")
        return out

    for n in MP_LANES:
        even, odd = affine_walk(n, SEED + n), affine_walk(n, SEED + 2 * n)
        b, a = (int.from_bytes(rng.bytes(16), "little") >> 1 for _ in range(2))
        for fb, fa in ((b, -a), (0, a)):
            if one_to_affine("fold_bases", fb, fa, even, odd) != host.fold_bases(fb, fa, even, odd):
                raise AssertionError(f"fold_bases at {n} lanes differs from HostEngine's")
        for k in (int.from_bytes(rng.bytes(32), "little") % R, 0):
            if one_to_affine("shared_mul", k, even) != host.shared_mul(k, even):
                raise AssertionError(f"shared_mul at {n} lanes (k = {k}) differs from HostEngine's")
    log(f"fold_bases and shared_mul at {', '.join(map(str, MP_LANES))} lanes (None lanes, zero "
        "scalars): equal to HostEngine's, one fold_many and one to_affine launch a call")


def multiparty_phase(dev, work, required):
    """Phase 11: multiparty proving through the CLI and in this process, the
    engine's fold_bases / shared_mul, and the multiparty profile.  Returns
    the launches by shape of the multiparty path: the mp-prove runs of (a)
    and (b) (the dealer's, and the parties' that run as threads here) and
    the CLI's verify of their files in this process, counted from 0; they
    must include every kernel of ``required``."""
    from bulletproofspp_tpu_torch import engine_profile
    from bulletproofspp_tpu_torch.core import range_proof as rpm
    from bulletproofspp_tpu_torch.core.engine import HostEngine
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    card = card_line()
    secs = {}
    kernels.reset_counts()
    # (a) the widest example over MP_PARTIES parties three ways, (b) the
    # binary family over TCP
    for label, extra in (("threads", ["--local"]), ("tcp", []),
                         ("tcp-host-parties", ["--party-engine", "host"])):
        secs[f"mp-prove {label}"] = mp_prove_checked(MP_EXAMPLE, MP_PARTIES, work, label, extra)
    mp_prove_checked(MP_BINARY, MP_BINARY_PARTIES, work, "binary")
    launches, shapes = kernels.counts(), kernels.shape_counts()
    require_launched("the multiparty path", launches, required)
    log(f"launches on the multiparty path: {launches}")

    spec_path, wit_path = example_files(MP_EXAMPLE)
    t0 = time.perf_counter()
    if run_cli(["prove", spec_path, wit_path, os.path.join(work, "mp_solo_c.bin"),
                os.path.join(work, "mp_solo_p.bin")]) != 0:
        raise AssertionError(f"prove {MP_EXAMPLE} failed")
    secs["cli prove"] = time.perf_counter() - t0
    log(f"{card}: {MP_EXAMPLE} wall seconds, mp-prove over {MP_PARTIES} parties and the CLI's "
        f"prove: {json.dumps(secs)}")

    # (c) in this process: one party owning every range gives the single
    # prover's (golden) bytes; MP_PARTIES seeded parties on the card give
    # HostEngine's
    spec, setup, values = engine_profile._load(MP_EXAMPLE)
    seed = spec.random_seed.encode()
    eng = TorchEngine(dev)
    solo = rpm.encode_proof(setup, rpm.prove(setup, values, seed, eng))
    one = rpm.encode_proof(setup, engine_profile.run_multiparty(setup, values, [seed], eng)[0])
    want_proof, want_coms = golden()[MP_EXAMPLE]
    digests = (hashlib.sha256(one[1]).hexdigest(), hashlib.sha256(one[0]).hexdigest())
    if one != solo or digests != (want_proof, want_coms):
        raise AssertionError(f"one party's {MP_EXAMPLE} proof differs from the single prover's")
    seeds = [f"smoke party {k}".encode() for k in range(MP_PARTIES)]
    t0 = time.perf_counter()
    on_card = rpm.encode_proof(setup, engine_profile.run_multiparty(setup, values, seeds, eng)[0])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_host = rpm.encode_proof(setup, engine_profile.run_multiparty(setup, values, seeds,
                                                                    HostEngine())[0])
    host_s = time.perf_counter() - t0
    if on_card != on_host:
        raise AssertionError(f"{MP_PARTIES} seeded parties on the card differ from HostEngine's")
    if not rpm.verify(setup, rpm.decode_proof(setup, *on_card, engine=eng), eng):
        raise AssertionError(f"the seeded {MP_PARTIES}-party proof does not verify")
    log(f"{MP_EXAMPLE}: one party's proof equal to the single prover's and the golden digest; "
        f"{MP_PARTIES} seeded parties on TorchEngine ({card_s:.3f} s) equal to HostEngine's "
        f"({host_s:.3f} s) byte for byte, and it verifies")

    # (d) the aggregated-opening demo, over TCP and in threads
    for extra in ([], ["--local"]):
        rc, out = cli_output(["mp-demo", "--parties", str(MP_DEMO_PARTIES), *extra])
        mode = "threads" if extra else f"{MP_DEMO_PARTIES} TCP subprocesses"
        if rc != 0 or f"Multiparty opening proof ({mode}): True" not in out:
            raise AssertionError(f"mp-demo ({mode}) rc {rc}: {out!r}")

    engine_interface(dev)  # (e)
    # (g) the dealer and parties on one engine against one prover
    log(f"{card}: multiparty profile: "
        f"{json.dumps(engine_profile.profile_multiparty(MP_PARTIES, TorchEngine(dev), MP_EXAMPLE))}")
    return shapes


def check_row_counts(dev, rng):
    """Phase 12 (b): the kernels that take a row count, at the sharded MSM's
    rows_local = 17 (win = 2: 34 padded rows) and 9 (win = 4: 36), on one
    MSM of 4,096 lanes whose first rows are zero padding (digit 0, sign 0:
    1 row at 17, 3 at 9) and with a row of zero digits and sign 1.  Each
    equals its plain version limb for limb (horner word for word);
    select_reduce's two designs, and select_reduce_fused against
    table_flat + select_reduce, are equal word for word."""
    from bulletproofspp_tpu_torch.ops import kernels, limb

    L = 4096
    p, _ = random_points(L, rng, dev)
    tabs = kernels.table_flat(p)
    for rows in (17, 9):
        absd = torch.as_tensor(rng.integers(0, 9, size=(1, rows, L)), dtype=torch.uint8, device=dev)
        sgn = torch.as_tensor(rng.integers(0, 2, size=(1, rows, L)), dtype=torch.uint8, device=dev)
        pad = {17: 1, 9: 3}[rows]
        absd[:, :pad], sgn[:, :pad] = 0, 0
        absd[:, pad + 1], sgn[:, pad + 1] = 0, 1
        sr = kernels.select_reduce(tabs, absd, sgn)
        same_raw(f"select_reduce rows={rows}: the gather and the staged design", sr,
                 kernels.select_reduce_design(tabs, absd, sgn, True))
        compare(f"select_reduce rows={rows}", sr, kernels.select_reduce_plain(tabs, absd, sgn))
        fused = kernels.select_reduce_fused(p, absd, sgn)
        same_raw(f"select_reduce_fused rows={rows} against table_flat + select_reduce", fused, sr)
        compare(f"select_reduce_fused rows={rows}", fused,
                kernels.select_reduce_fused_plain(p, absd, sgn))
        rb = kernels.reduce_block(sr, 4)  # ops.msm._narrow: 512 lanes a row -> 128
        compare(f"reduce_block rows={rows}", rb, kernels.reduce_block_plain(sr, 4))
        th = tuple(t.reshape(limb.NLIMB, 1, rows * 128) for t in rb)
        compare(f"tail_horner rows={rows}", kernels.tail_horner(th, rows),
                kernels.tail_horner_plain(th, rows))
        for K in (1, 2):
            r = horner_rows(K, rng, dev, rows)
            for c in r:  # the padding rows' sums are the identity
                c[:, :, :pad] = limb.ones((K, pad), dev) if c is r[1] else 0
            same_raw(f"horner K={K} rows={rows}", kernels.horner(*r), kernels.horner_plain(*r))
    torch.cuda.synchronize()
    log("rows 17 and 9 (MSB zero rows with sign 0, a zero row with sign 1), 4,096 lanes: "
        "select_reduce (both designs), select_reduce_fused, reduce_block and tail_horner equal "
        "to their plain versions limb for limb, horner (K = 1, 2) word for word")


def sharded_phase(dev, blobs, required):
    """Phase 12: the sharded MSM.  Returns the launches by shape of (c), (d)
    and (e), counted from 0 (the 2-rank runs of (d) launch in their own
    processes and report their launches), which must include every kernel
    of ``required``."""
    from bulletproofspp_tpu_torch import dryrun
    from bulletproofspp_tpu_torch.ops import kernels, sharded
    from bulletproofspp_tpu_torch.ops.engine import ShardedTorchEngine

    card = card_line()
    log(f"phase 12: torch.cuda.device_count() = {torch.cuda.device_count()}")  # (a)
    check_row_counts(dev, np.random.default_rng(SEED + 12))  # (b)
    pairs, want = dryrun.msm_case(WIDE_LANES // 2, SEED + 6)
    kernels.reset_counts()
    # (c) phase 6's MSM over a mesh of two entries in this process
    entries = sharded.device_entries(DEVICE, 2)
    for win in (1, 2):
        eng = ShardedTorchEngine(entries[0], mesh=sharded.make_mesh(entries, win))
        record = {"win": win, "entries": [str(d) for d in entries]}
        with dryrun.measured(record, entries[0]):
            got = eng.msm(pairs)
        if got != want:
            raise AssertionError(f"the sharded 2^21-lane MSM at win={win} differs from phase 6's "
                                 "host answer")
        log(f"{card}: sharded 2^21-lane MSM in one process, equal to the host answer: "
            f"{json.dumps(record)}")
    # (d) two rank processes over gloo: the same MSM at win 2 and 1, then
    # phase 7's proofs with proof BATCH_BAD flipped
    with open(os.path.join(HERE, "examples", "64bit", "schema.json")) as f:
        spec_obj = json.load(f)
    with tempfile.TemporaryDirectory(prefix="bppp_sharded_") as d:
        corpus = dryrun.write_corpus(os.path.join(d, "corpus.pkl"), spec_obj, blobs, BATCH_BAD)
        t0 = time.perf_counter()
        msm_runs, batch_runs = dryrun.dryrun_multiprocess(
            2, protocol=True, device=DEVICE, msm_pairs=WIDE_LANES // 2, msm_seed=SEED + 6,
            corpus=corpus)
        secs = time.perf_counter() - t0
    for rank, runs in enumerate(msm_runs):
        if [r["result"] for r in runs] != [[str(want[0]), str(want[1])]] * 2:
            raise AssertionError(f"rank {rank}: the 2-process MSM differs from phase 6's answer")
    for rank, (run,) in enumerate(batch_runs):
        if (run["proofs"], run["bad"], run["result"]) != (BATCH_N, BATCH_BAD, [True, False]):
            raise AssertionError(f"rank {rank}: the 2-process batch verify gave {run}")
    for rank, runs in enumerate(zip(msm_runs, batch_runs)):
        for run in (*runs[0], *runs[1]):
            log(f"{card}: rank {rank} of 2: {json.dumps(run)}")
    log(f"dryrun_multiprocess (2 ranks; 2^21-lane MSM at win 2 and 1, {BATCH_N} proofs accepted "
        f"and rejected with proof {BATCH_BAD} flipped): {secs:.3f} s of wall")
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(2, DEVICE)  # (e)
    torch.cuda.synchronize()
    log(f"dryrun_multichip(2, {DEVICE}): passed, {time.perf_counter() - t0:.3f} s")
    shapes = kernels.shape_counts()
    require_launched("the sharded path", kernels.counts(), required)
    log(f"launches on the sharded path: {kernels.counts()}")
    return shapes


def edge_planes(L: int, rng, dev, shift: int = 0):
    """(16, L) strict planes of numpy-seeded random limbs (values over the
    full 256-bit range, so not canonical) whose first lanes hold the edge
    values (0, 1, Q, Q - 1, Q + 1, 2^256 - 1, saturated 0xFFFF runs),
    rotated by ``shift``."""
    from bulletproofspp_tpu_torch.core.fields import Q
    from bulletproofspp_tpu_torch.ops import limb

    edge = [0, 1, Q, Q - 1, Q - 2, Q + 1, (1 << 256) - 1, (1 << 256) % Q, (1 << 128) - 1,
            int("FFFF" * 8 + "0000" * 8, 16), int("FFFF0000" * 8, 16), 0]
    t = torch.as_tensor(rng.integers(0, 1 << 16, size=(limb.NLIMB, L)), device=dev)
    vals = edge[shift:] + edge[:shift]
    k = min(L, len(vals))
    t[:, :k] = limb.from_ints(vals[:k], dev)
    return t


def check_affine(dev):
    """Phase 13 (a): inv and to_affine against their plain versions at
    AFFINE_WIDTHS, edge lanes (``edge_planes``: z = 0, Q, Q - 1, x = 0,
    saturated limbs) included; both give canonical words, so the outputs
    and the identity mask must be equal word for word.  Each timed (CUDA ms
    back to back, the plain version's as the host sends it) at
    AFFINE_TIMED.  Returns the kernel rows."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 13)
    rows = []
    for L in AFFINE_WIDTHS:
        a = edge_planes(L, rng, dev)
        x, y, z = (edge_planes(L, rng, dev, shift) for shift in (5, 3, 0))
        for name, got, want in (("inv", (kernels.inv(a),), (kernels.inv_plain(a),)),
                                ("to_affine", kernels.to_affine(x, y, z),
                                 kernels.to_affine_plain(x, y, z))):
            err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item())
                      for g, w in zip(got, want))
            if err != 0:
                raise AssertionError(f"kernel {name} L={L} disagrees with its plain version: "
                                     f"max |diff| {err}")
        if L in AFFINE_TIMED:
            rows += [("inv", 0, time_ms(lambda: kernels.inv(a), 10),
                      time_ms(lambda: kernels.inv_plain(a), 1, paced=True), f"L={L}",
                      bounds.inv(L), {"batches": bounds.inv_chain()}),
                     ("to_affine", 0, time_ms(lambda: kernels.to_affine(x, y, z), 10),
                      time_ms(lambda: kernels.to_affine_plain(x, y, z), 1, paced=True), f"L={L}",
                      bounds.to_affine(L), {"batches": bounds.to_affine_chain()})]
    log(f"inv and to_affine at {', '.join(map(str, AFFINE_WIDTHS))} lanes (z = 0, Q, Q - 1, x = 0 "
        "and saturated lanes among them): equal to their plain versions word for word")
    return rows


def affine_phase(dev):
    """Phase 13 (b): counted from 0, the affine path at AFFINE_LANES lanes
    alone: one TorchEngine.fold_bases and one shared_mul (fold_many 2, the
    second making shared_mul's phi in its launch, to_affine 2, nothing
    else).
    Only after the counts are read: both equal to their route before device
    affine conversion (the fold's lanes normalized, copied and inverted on
    the host,
    ``DevicePoints.to_host``) and to the JAX package's route through the
    port's field (limb.batch_inv of the fold's Z, then limb.inv of 16
    lanes); the walls of both routes logged in turns, with the seconds of
    the host inverses alone.  Returns the path's launches by shape."""
    from bulletproofspp_tpu_torch import native
    from bulletproofspp_tpu_torch.core.fields import R
    from bulletproofspp_tpu_torch.ops import curve, glv, kernels, limb, msm
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine, _dp_pad, _dp_slice, DevicePoints

    n = AFFINE_LANES
    eng = TorchEngine(dev)
    rng = np.random.default_rng(SEED + 131)
    even, odd = affine_walk(n, SEED + 13), affine_walk(n, SEED + 26)
    b, a = (int.from_bytes(rng.bytes(16), "little") >> 1 for _ in range(2))
    k = int.from_bytes(rng.bytes(32), "little") % R

    def shared_mul_host_inverse():
        p = _dp_pad(eng.basevec(even), n)
        pe = p.coords()
        k1, k2 = glv.split(k)
        out = msm.fold_mul(pe, curve.endo(pe), *native.recode_signed(k1),
                           *native.recode_signed(k2))
        return _dp_slice(DevicePoints(*out), n).to_host()

    routes = {
        "fold_bases": lambda: eng.fold_bases(b, -a, even, odd),
        "fold_bases, host inverse": lambda: eng.fold_bv(b, -a, even, odd).to_host(),
        "shared_mul": lambda: eng.shared_mul(k, even),
        "shared_mul, host inverse": shared_mul_host_inverse,
    }
    kernels.reset_counts()
    got = {name: routes[name]() for name in ("fold_bases", "shared_mul")}
    torch.cuda.synchronize()
    launches, shapes = kernels.counts(), kernels.shape_counts()
    want = {"fold_many": 2, "to_affine": 2}
    if {name: c for name, c in launches.items() if c} != want:
        raise AssertionError(f"the affine path launched {launches}, want {want} and nothing else")
    for name in ("fold_bases", "shared_mul"):
        if got[name] != routes[f"{name}, host inverse"]():
            raise AssertionError(f"{name} at {n} lanes differs from the host-inverse route")
    # the JAX package's to_affine, step by step through the port's field
    fx, _, fz = msm.fold_mul(*eng._fold_args(b, -a, even, odd)[0])
    zi = limb.batch_inv(fz)
    if limb.unpack_ints(limb.normalize(limb.mul(fx, zi))) != [
            0 if p is None else p[0] for p in got["fold_bases"]]:
        raise AssertionError("limb.batch_inv's x / z differs from fold_bases'")
    if not torch.equal(limb.inv(fz[:, :16]), zi[:, :16]):
        raise AssertionError("limb.inv differs from limb.batch_inv")
    walls = {name: [] for name in routes}
    for name in [*routes, *reversed(routes)] * 2:
        t0 = time.perf_counter()
        routes[name]()
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    planes = limb.planes_to_numpy(curve.normalize3(*eng.fold_bv(b, -a, even, odd).coords()))
    t0 = time.perf_counter()
    curve.affine_from_normalized(planes)
    host_s = time.perf_counter() - t0
    log(f"{card_line()}: fold_bases and shared_mul at {n} lanes equal to the host-inverse route "
        f"and to limb.batch_inv / limb.inv; wall seconds in turns {json.dumps(walls)}; the {n} "
        f"host inverses alone {host_s:.4f} s; launches on the affine path {launches}")
    return shapes


def lanes_equal(name, got, want):
    """Largest difference of the kernel's (16, *batch) planes and the plain
    version's after normalization; raises unless the kernel's are strict
    and the difference is 0."""
    from bulletproofspp_tpu_torch.ops import limb

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or int(g.min()) < 0 or int(g.max()) > limb.MASK:
            raise AssertionError(f"kernel {name}: output not strict or of another shape")
        err = max(err, int((limb.normalize(g.reshape(16, -1)) - limb.normalize(w.reshape(16, -1)))
                           .abs().max().item()))
    if err:
        raise AssertionError(f"kernel {name} disagrees with its plain version: max |diff| {err}")
    return err


def check_lane_ops(dev):
    """Phase 15 (a): the four kernels of csrc/lanes.cu against their plain
    versions, ``edge_planes`` lanes (0, Q, Q - 1, [Q, 2^256), saturated
    limbs) among the inputs: select_small at B x L of SELECT_BATCHES x
    SELECT_LANES (row 0 zero digits with sign 1) word for word; endo with
    the interleave at 8 to 2,048 lanes and at ENDO_STACKS, endo and pneg at
    NEG_LANES and lockstep's (16, 16, 16), after normalization, strict out
    (the interleave's P lanes word for word); normalize3 at NORMALIZE_K word
    for word.  Each timed at the main paths' commonest shapes
    (SELECT_TIMED, ENDO_TIMED, L = 16, NORMALIZE_TIMED) on the inputs it
    was checked on there, whose max |diff| is the row's (CUDA ms back to
    back, the plain version's as the host sends it); select_small in turns
    with select_plain's three torch.gather (its library call).  Returns the
    kernel rows."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 15)

    def points(shape, shift=0):
        n = int(np.prod(shape))
        return tuple(edge_planes(n, rng, dev, shift + s).reshape(16, *shape) for s in (5, 3, 0))

    rows = []

    def timed(name, err, fn, plain, shape, work):
        rows.append((name, err, time_ms(fn, 20), time_ms(plain, 5, paced=True), shape, work))

    for batch in SELECT_BATCHES:
        tabs = kernels.table_flat(points((batch * max(SELECT_LANES),)))
        for L in SELECT_LANES:
            n = batch * L
            tb = tuple(t[:, :n].contiguous() for t in tabs)
            absd = torch.as_tensor(rng.integers(0, 9, size=(batch, ROWS, L)), dtype=torch.uint8, device=dev)
            sgn = torch.as_tensor(rng.integers(0, 2, size=(batch, ROWS, L)), dtype=torch.uint8, device=dev)
            absd[:, 0], sgn[:, 0] = 0, 1
            err = same_raw(f"select_small B={batch} L={L}", kernels.select_small(tb, absd, sgn),
                           kernels.select_plain(tb, absd, sgn))
            if (batch, L) in SELECT_TIMED:
                means, both = in_turns({"kernel": lambda: kernels.select_small(tb, absd, sgn),
                                        "library": lambda: kernels.select_plain(tb, absd, sgn)},
                                       20)
                log(f"select_small B={batch} L={L} in turns with select_plain (ms): "
                    f"{json.dumps(both)}")
                rows.append(("select_small", err, means["kernel"],
                             time_ms(lambda: kernels.select_plain(tb, absd, sgn), 5, paced=True),
                             f"B={batch} L={L} rows={ROWS}", bounds.select_small(absd, sgn),
                             {"library_ms": means["library"]}))

    stacks = [(1, n) for n in (8, 16, 32, 64, 128, 256, 512, 1024, 2048)] + list(ENDO_STACKS)
    for k, n in stacks:
        p = points((k, n) if k > 1 else (n,), k + n)
        err = lanes_equal(f"endo K={k} n={n} interleave", kernels.endo(p, interleave=True),
                          kernels.endo_plain(p, interleave=True))
        if not torch.equal(kernels.endo(p, interleave=True)[0][..., 0::2], p[0]):
            raise AssertionError(f"endo K={k} n={n}: the interleave's P lanes differ")
        if (k, n) in ENDO_TIMED:
            timed("endo", err, lambda: kernels.endo(p, interleave=True),
                  lambda: kernels.endo_plain(p, interleave=True), f"K={k} n={n} interleave",
                  bounds.endo(k * n, True))
    for n in ENDO_WIDE:  # the interleave of lanes uploaded from the host
        p = points((n,), n % 7)
        err = lanes_equal(f"endo n={n} interleave", kernels.endo(p, interleave=True),
                          kernels.endo_plain(p, interleave=True))
        timed("endo", err, lambda: kernels.endo(p, interleave=True),
              lambda: kernels.endo_plain(p, interleave=True), f"K=1 n={n} interleave",
              bounds.endo(n, True))
    for shape in [(n,) for n in NEG_LANES] + [(16, 16)]:
        p = points(shape, len(shape))
        errs = {name: lanes_equal(f"{name} {shape}", getattr(kernels, name)(p),
                                  getattr(kernels, f"{name}_plain")(p))
                for name in ("endo", "pneg")}
        if shape == (16,):
            timed("endo", errs["endo"], lambda: kernels.endo(p), lambda: kernels.endo_plain(p),
                  "L=16", bounds.endo(16, False))
            timed("pneg", errs["pneg"], lambda: kernels.pneg(p), lambda: kernels.pneg_plain(p),
                  "L=16", bounds.pneg(16))
    for K in NORMALIZE_K:
        q = points((K,), K)
        err = same_raw(f"normalize3 K={K}", (kernels.normalize3(*q),),
                       (kernels.normalize3_plain(*q),))
        if K in NORMALIZE_TIMED:
            timed("normalize3", err, lambda: kernels.normalize3(*q),
                  lambda: kernels.normalize3_plain(*q), f"K={K}", bounds.normalize3(K))
    log(f"lane kernels against their plain versions: select_small at B = {SELECT_BATCHES} x L = "
        f"{SELECT_LANES} word for word; endo interleaved at 8-2,048 lanes, {ENDO_STACKS} and "
        f"{ENDO_WIDE} lanes, endo "
        f"and pneg at {NEG_LANES} and (16, 16, 16) after normalization, strict; normalize3 at K = "
        f"{NORMALIZE_K} word for word (edge lanes in every input)")
    return rows


def fused_shapes(cli_shapes) -> dict:
    """The (B, L) of cli test's first-level selects by launch count
    ({(B, L): launches}: reduce_block's "W=... f=... tables" launches, L =
    128 f, and tail_horner's "K=... tables" ones, L = 128), and horner's
    canonical K ({K: launches})."""
    sel, canon = collections.Counter(), collections.Counter()
    for shape, n in cli_shapes["reduce_block"].items():
        if "tables" in shape.split():
            d = parse_shape(shape)
            sel[d["W"] // (ROWS * 128 * d["f"]), 128 * d["f"]] += n
    for shape, n in cli_shapes["tail_horner"].items():
        if "tables" in shape.split():
            sel[parse_shape(shape)["K"], 128] += n
    for shape, n in cli_shapes["horner"].items():
        if "canonical" in shape.split():
            canon[parse_shape(shape)["K"]] += n
    return {"select": dict(sel), "canonical": dict(canon)}


def check_fused_selects(dev, cli_shapes):
    """Phase 15 (a'): msm's route from 128 to 1,023 lanes selects in its
    first launch and stores its result canonical.  At B of FUSED_BATCHES
    MSMs of L of FUSED_LANES lanes and ROWS rows (``msm_operands``: zero
    digits with sign 1, cancelling and doubling rows, identity lanes):
    reduce_block from the tables (L = 256, 512; both designs) equal word
    for word to select_small + reduce_block on the selected planes, and to
    its plain version after normalization; tail_horner from the tables (L
    = 128) the same, and canonical equal word for word to normalize3 of
    it; horner canonical at CANONICAL_K equal word for word to normalize3
    of horner.  Timed (CUDA ms back to back; in turns with the unfused
    route: select_small + the kernel, or the kernel + normalize3) at cli
    test's commonest shapes (``fused_shapes``), at FUSED_TIMED and horner
    at K = CANONICAL_TIMED.  Returns the kernel rows."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import curve, kernels

    rng = np.random.default_rng(SEED + 151)
    seen = fused_shapes(cli_shapes)
    log(f"cli test's first-level selects (B, L): launches {json.dumps(list(seen['select'].items()))}"
        f"; horner canonical K: launches {json.dumps(list(seen['canonical'].items()))}")
    timed = set(FUSED_TIMED)
    if seen["select"]:
        by_l = collections.defaultdict(dict)
        for (B, L), n in seen["select"].items():
            by_l[L == 128][B, L] = n
        timed |= {max(sorted(c), key=c.get) for c in by_l.values()}
    k_timed = {CANONICAL_TIMED} | ({max(sorted(seen["canonical"]), key=seen["canonical"].get)}
                                   if seen["canonical"] else set())
    rows = []

    def flat(p):
        return tuple(t.reshape(16, -1) for t in p)

    for B in sorted(set(FUSED_BATCHES) | {b for b, _ in timed}):
        for L in sorted(set(FUSED_LANES) | {l for b, l in timed if b == B}):
            tabs, absd, sgn = msm_operands(B, L, rng, dev)
            label = f"B={B} L={L}"
            sel = kernels.select_small(tabs, absd, sgn)
            if L == 128:
                got = kernels.tail_horner(tabs, ROWS, absd=absd, sgn=sgn)
                same_raw(f"tail_horner {label} from the tables against select_small + "
                         "tail_horner", got,
                         kernels.tail_horner(tuple(t.reshape(16, B, -1) for t in sel), ROWS))
                canon = kernels.tail_horner(tabs, ROWS, canonical=True, absd=absd, sgn=sgn)
                same_raw(f"tail_horner {label} canonical against normalize3 of it", (canon,),
                         (curve.normalize3(*got),))
                plain = lambda: kernels.tail_horner_plain(  # noqa: E731
                    tabs, ROWS, True, absd, sgn)
                err = compare(f"tail_horner {label} canonical, from the tables", tuple(canon),
                              tuple(plain()))
                if (B, L) not in timed:
                    continue
                fused = lambda: kernels.tail_horner(  # noqa: E731
                    tabs, ROWS, canonical=True, absd=absd, sgn=sgn)
                unfused = lambda: curve.normalize3(*kernels.tail_horner(  # noqa: E731
                    tuple(t.reshape(16, B, -1) for t in kernels.select_small(tabs, absd, sgn)),
                    ROWS))
                means, both = in_turns({"fused": fused, "unfused": unfused}, 10)
                log(f"tail_horner {label} from the tables, canonical, in turns with select_small "
                    f"+ tail_horner + normalize3 (ms): {json.dumps(both)}")
                rows.append(("tail_horner", err, time_ms(fused, 10), time_ms(plain, 1, paced=True),
                             f"K={B} tables canonical", bounds.tail_horner_tables(absd, sgn, True),
                             {"unfused_ms": means["unfused"], "fused_in_turns_ms": means["fused"]}))
                continue
            f = L // 128
            for narrow in (True, False):
                got = kernels.reduce_block_design(tabs, f, narrow, absd, sgn)
                same_raw(f"reduce_block {label} {'narrow' if narrow else 'wide'} from the tables "
                         "against select_small + reduce_block", got,
                         kernels.reduce_block_design(flat(sel), f, narrow))
            kernels.reset_counts()
            got = kernels.reduce_block(tabs, f, absd=absd, sgn=sgn)
            design = commonest(kernels.shape_counts()["reduce_block"]).split()[-1]
            err = compare(f"reduce_block {label} from the tables", got,
                          kernels.reduce_block_plain(tabs, f, absd, sgn))
            if (B, L) not in timed:
                continue
            fused = lambda: kernels.reduce_block(tabs, f, absd=absd, sgn=sgn)  # noqa: E731
            unfused = lambda: kernels.reduce_block(  # noqa: E731
                flat(kernels.select_small(tabs, absd, sgn)), f)
            means, both = in_turns({"fused": fused, "unfused": unfused}, 20)
            log(f"reduce_block {label} ({design}) from the tables, in turns with select_small + "
                f"reduce_block (ms): {json.dumps(both)}")
            if design == "narrow" and means["fused"] > means["unfused"]:
                raise AssertionError(f"reduce_block {label} from the tables took {means['fused']} "
                                     f"ms, select_small + reduce_block {means['unfused']}")
            rows.append(("reduce_block", err, time_ms(fused, 20),
                         time_ms(lambda: kernels.reduce_block_plain(tabs, f, absd, sgn), 2,
                                 paced=True),
                         f"W={B * ROWS * L} f={f} tables {design} ({label})",
                         bounds.reduce_block_tables(absd, sgn, f),
                         {"chain": bounds.reduce_block_chain(f, design == "narrow"),
                          "unfused_ms": means["unfused"], "fused_in_turns_ms": means["fused"]}))
    for K in sorted(set(CANONICAL_K) | k_timed):
        r = horner_rows(K, rng, dev)
        got = kernels.horner(*r, canonical=True)
        same_raw(f"horner K={K} canonical against normalize3 of horner", (got,),
                 (curve.normalize3(*kernels.horner(*r)),))
        if K not in k_timed:
            continue
        err = compare(f"horner K={K} canonical", tuple(got),
                      tuple(kernels.horner_plain(*r, canonical=True)))
        means, both = in_turns({
            "canonical": lambda: kernels.horner(*r, canonical=True),
            "projective": lambda: kernels.horner(*r),
            "then_normalize3": lambda: curve.normalize3(*kernels.horner(*r))}, 20)
        log(f"horner K={K} canonical, in turns with the projective stores and with normalize3 "
            f"after them (ms): {json.dumps(both)}; canonical / projective "
            f"{means['canonical'] / means['projective']:.4f}")
        rows.append(("horner", err, time_ms(lambda: kernels.horner(*r, canonical=True), 20),
                     time_ms(lambda: kernels.horner_plain(*r, canonical=True), 1, paced=True),
                     f"K={K} canonical", bounds.horner(K, ROWS, True),
                     {"projective_ms": means["projective"],
                      "then_normalize3_ms": means["then_normalize3"],
                      "canonical_in_turns_ms": means["canonical"]}))
    log(f"first-level selects at B = {FUSED_BATCHES} x L = {FUSED_LANES} ({ROWS} rows; zero "
        "digits with sign 1, cancelling and doubling rows, identity lanes): reduce_block (both "
        "designs) and tail_horner from the tables equal word for word to select_small + the "
        "kernel, to their plain versions after normalization; canonical tail_horner and horner "
        f"(K = {CANONICAL_K}) equal word for word to normalize3 of their projective stores")
    return rows


def assemble_equal(name, got, want, interleave: bool) -> int:
    """assemble's outputs against assemble_plain's: word for word, but for
    the phi lanes' x (the odd lanes of an interleave), which must be strict
    and equal after normalization.  Returns the max |diff| (0)."""
    from bulletproofspp_tpu_torch.ops import limb

    for g, w in zip(got, want):
        for c, (a, b) in enumerate(zip(g, w)):
            if a.shape != b.shape or not a.is_contiguous():
                raise AssertionError(f"assemble {name}: an output of another shape or strided")
            if interleave and c == 0:
                phi = a[..., 1::2]
                if int(phi.min()) < 0 or int(phi.max()) > limb.MASK:
                    raise AssertionError(f"assemble {name}: phi lanes not strict")
                lanes_equal(f"assemble {name} phi", (phi,), (b[..., 1::2],))
                a, b = a[..., 0::2], b[..., 0::2]
            if not torch.equal(a, b):
                raise AssertionError(f"assemble {name}: coordinate {c} differs from its plain "
                                     "version word for word")
    return 0


def parse_shape(shape: str) -> dict:
    """"S=2 K=16 L=16 interleave" -> {"S": 2, "K": 16, "L": 16, "interleave": True}."""
    words = shape.split()
    out = {k: int(v) for k, v in (w.split("=") for w in words if "=" in w)}
    out["interleave"] = "interleave" in words
    return out


def commonest(by_shape: dict) -> str:
    return max(sorted(by_shape), key=by_shape.get)


def msm_entries(K: int, L: int, pool, rng):
    """K msm_many entries of 1-ASSEMBLE_GROUPS groups whose active counts
    are not powers of two, at most L / 2 lanes an entry: each group a slice
    of the (16, M) ``pool`` planes (the row stride M, not the count), entry
    0's first at lane 0 (the pool's edge lanes).  Returns the entries and
    their lanes."""
    M = pool[0].shape[1]
    units = L // 2
    entries, lanes = [], 0
    for k in range(K):
        total = int(rng.integers(max(1, units // 2), units + 1))
        if total > 2 and total & (total - 1) == 0:
            total -= 1
        g = int(rng.integers(1, min(ASSEMBLE_GROUPS, total) + 1))
        cuts = sorted(rng.choice(np.arange(1, total), size=g - 1, replace=False)) if g > 1 else []
        counts = np.diff([0, *cuts, total])
        segs = []
        for i, n in enumerate(counts):
            off = 0 if k == i == 0 else int(rng.integers(0, M - n + 1))
            segs.append(tuple(c[:, off:off + n] for c in pool))
        entries.append(segs)
        lanes += total
    return entries, lanes


def check_assembly(dev, cli_shapes):
    """Phase 16 (a): assemble against assemble_plain (``assemble_equal``)
    at the main paths' shapes, every input holding ``edge_planes`` lanes
    (0, 1, Q, Q - 1, [Q, 2^256), saturated limbs): msm_many's K of
    ASSEMBLE_K entries of 1-4 groups whose active counts are not powers of
    two, interleaved, at each lane bucket phase 3's ``cli test`` gave that K
    (64 where it gave none); bv_split's stride-2 halves of SPLIT_LANES
    (odd) lanes; lockstep's two stacks of 16 provers' 13 lanes to 16; the
    two 4,095-lane bases of a 4,096-lane fold_bases; and two calls whose
    table must split into launches by entries: ASSEMBLE_SPLIT_K entries of
    4 groups at the library's capacity, and 130 entries of 4 groups at the
    pre-12.1 parameter limit's (ASSEMBLE_SMALL_CAPACITY), each launching
    more than once.  Timed at the shape phase 3 launched most (CUDA ms back
    to back, the plain version's as the host sends it).
    (b) the fused reduce_lanes (``reduce_lanes_equal``) at L of
    REDUCE_LANES_L and B of REDUCE_LANES_B MSMs of ROWS rows, then timed at
    the shape phase 3 launched most: in turns with the unfused route it
    replaces (select_small, then the same kernel's tree alone on the
    selected planes), and stopped after each level (``levels``), in
    turns, for the per-level figure.  Returns the kernel rows."""
    from bulletproofspp_tpu_torch import bounds
    from bulletproofspp_tpu_torch.ops import kernels

    rng = np.random.default_rng(SEED + 16)
    pool = tuple(edge_planes(8192, rng, dev, s) for s in (5, 3, 0))
    seen = collections.defaultdict(set)
    for shape in cli_shapes["assemble"]:
        d = parse_shape(shape)
        if d["interleave"]:
            seen[d["K"]].add(d["L"])
    cases = []  # (label, outputs, L, interleave, capacity)
    for K in ASSEMBLE_K:
        for L in sorted(seen[K]) or [64]:
            cases.append((f"msm_many K={K} L={L}" + ("" if seen[K] else " (not in phase 3)"),
                          [msm_entries(K, L, pool, rng)[0]], L, True, None))
    for n in SPLIT_LANES:
        full = tuple(c[:, 1:n + 1] for c in pool)  # a slice of an odd count
        cases.append((f"bv_split n={n}", [[[tuple(c[:, s::2] for c in full)]] for s in (0, 1)],
                      (n + 1) // 2, False, None))
    stacks = [[[tuple(c[:, 16 * b + s:16 * b + s + 13] for c in pool)] for b in range(16)]
              for s in (0, 1)]
    cases.append(("lockstep 16 x 13 to 16", stacks, 16, False, None))
    cases.append(("fold_bases 2 x 4,095 to 4,096", [[[tuple(c[:, s:s + 4095] for c in pool)]]
                                                     for s in (0, 1)], 4096, False, None))
    split = [[[tuple(c[:, 7 * k + g:7 * k + g + 5 + g] for c in pool) for g in range(4)]
              for k in range(ASSEMBLE_SPLIT_K)]]
    cases.append((f"split: {ASSEMBLE_SPLIT_K} x 4 groups", split, 64, True, None))
    cases.append((f"split: 130 x 4 groups at {ASSEMBLE_SMALL_CAPACITY} bytes a launch",
                  [split[0][:130]], 64, True, ASSEMBLE_SMALL_CAPACITY))
    capacity = kernels.assemble_capacity
    launches = {}
    for label, outputs, L, interleave, cap in cases:
        kernels.reset_counts()
        if cap:
            kernels.assemble_capacity = lambda: cap
        try:
            got = kernels.assemble(outputs, L, interleave)
        finally:
            kernels.assemble_capacity = capacity
        launches[label] = kernels.counts()["assemble"]
        err = assemble_equal(label, got, kernels.assemble_plain(outputs, L, interleave),
                             interleave)
        if label.startswith("split") and launches[label] < 2:
            raise AssertionError(f"assemble {label}: {launches[label]} launch, not split")
    log(f"assemble against its plain version (phi lanes after normalization, strict; every other "
        f"word equal), launches a call: {json.dumps(launches)}; {capacity()} bytes of table a "
        f"launch at most")

    rows = []
    timed = parse_shape(commonest(cli_shapes["assemble"]))
    S, K, L, interleave = timed["S"], timed["K"], timed["L"], timed["interleave"]
    outputs = [msm_entries(K, L if interleave else 2 * L, pool, rng)[0] for _ in range(S)]
    n_in = sum(seg[0].shape[1] for entries in outputs for segs in entries for seg in segs)
    err = assemble_equal("timed", kernels.assemble(outputs, L, interleave),
                         kernels.assemble_plain(outputs, L, interleave), interleave)
    rows.append(("assemble", err, time_ms(lambda: kernels.assemble(outputs, L, interleave), 20),
                 time_ms(lambda: kernels.assemble_plain(outputs, L, interleave), 5, paced=True),
                 f"S={S} K={K} L={L}{' interleave' if interleave else ''} ({n_in} lanes in)",
                 bounds.assemble(n_in, S * K * L, interleave)))

    for L in REDUCE_LANES_L:
        for B in REDUCE_LANES_B:
            reduce_lanes_equal(f"reduce_lanes B={B} L={L}", *msm_operands(B, L, rng, dev))
    log(f"reduce_lanes at L = {REDUCE_LANES_L} x B = {REDUCE_LANES_B} MSMs of {ROWS} rows (zero "
        "digits with sign 1, cancelling and doubling rows, identity lanes): equal word for word to "
        "select_small + the padd route and to select_small + its tree alone, to its plain version "
        "after normalization")
    timed = parse_shape(commonest(cli_shapes["reduce_lanes"]))
    B, L = timed["B"], timed["L"]
    tabs, absd, sgn = msm_operands(B, L, rng, dev)
    err = reduce_lanes_equal(f"reduce_lanes B={B} L={L} (timed)", tabs, absd, sgn)
    fused = lambda: kernels.reduce_lanes(tabs, absd, sgn)  # noqa: E731
    unfused = lambda: kernels.reduce_lanes_tree(kernels.select_small(tabs, absd, sgn))  # noqa: E731
    means, both = in_turns({"fused": fused, "unfused": unfused}, 20)
    log(f"reduce_lanes B={B} L={L} in turns with select_small + its tree alone (ms): "
        f"{json.dumps(both)}")
    levels = L.bit_length() - 1
    per_level, by_level = in_turns(
        {k: (lambda k=k: kernels.reduce_lanes(tabs, absd, sgn, levels=k))
         for k in range(1, levels + 1)}, 20)
    steps = [per_level[k + 1] - per_level[k] for k in range(1, levels)]
    log(f"reduce_lanes B={B} L={L} stopped after 1..{levels} levels, in turns (ms): "
        f"{json.dumps(by_level)}; each level past the first "
        f"{json.dumps([round(v, 5) for v in steps])} ms")
    ms = time_ms(fused, 20)
    log(f"reduce_lanes B={B} L={L}: {ms:.4f} ms back to back; the padd route it replaces "
        f"{time_ms(lambda: tree_route(kernels.select_small(tabs, absd, sgn)), 5, paced=True):.4f} "
        f"ms as the host sends it")
    rows.append(("reduce_lanes", err, ms,
                 time_ms(lambda: kernels.reduce_lanes_plain(tabs, absd, sgn), 5, paced=True),
                 f"B={B} L={L} rows={ROWS}", bounds.reduce_lanes(absd, sgn),
                 {"chain": bounds.reduce_lanes_chain(L), "unfused_ms": means["unfused"],
                  "fused_in_turns_ms": means["fused"],
                  "levels_ms": [per_level[k] for k in range(1, levels + 1)],
                  "per_level_ms": sum(steps) / len(steps)}))
    return rows


def tree_route(p):
    """The lane tree as the padd kernel ran it before reduce_lanes."""
    from bulletproofspp_tpu_torch.ops import kernels

    width = p[0].shape[-1]
    while width > 1:
        h = width // 2
        p = kernels.padd(tuple(t[..., :h] for t in p), tuple(t[..., h:] for t in p))
        width = h
    return tuple(t[..., 0] for t in p)


def msm_operands(B: int, L: int, rng, dev):
    """table_flat's tables of B MSMs of L lanes (``wide_points``; in each MSM
    lane t + L/2 the point of lane t with another Z) and their (B, ROWS, L)
    digits: row 0 zero digits with sign 1, in row 1 lane t + L/2 the digit
    of lane t with the other sign (the first level adds P and -P), in row 2
    with the same sign (P + P), the rest random."""
    from bulletproofspp_tpu_torch.ops import kernels, limb

    x, y, z = (c.reshape(16, B, L) for c in wide_points(B * L, rng, dev))
    h = L // 2
    k = torch.as_tensor(rng.integers(1, 1 << 16, size=(limb.NLIMB, B, h)), device=dev)
    for c in (x, y, z):
        c[:, :, h:] = limb.mul(c[:, :, :h], k)
    absd = torch.as_tensor(rng.integers(0, 9, size=(B, ROWS, L)), dtype=torch.uint8, device=dev)
    sgn = torch.as_tensor(rng.integers(0, 2, size=(B, ROWS, L)), dtype=torch.uint8, device=dev)
    absd[:, 0], sgn[:, 0] = 0, 1
    absd[:, 1:3, h:] = absd[:, 1:3, :h]
    sgn[:, 1, h:], sgn[:, 2, h:] = 1 - sgn[:, 1, :h], sgn[:, 2, :h]
    return kernels.table_flat(tuple(c.reshape(16, -1) for c in (x, y, z))), absd, sgn


def reduce_lanes_equal(label, tabs, absd, sgn) -> int:
    """The fused reduce_lanes against select_small + the padd route and
    against select_small + its tree alone, raw, and against its plain
    version after normalization (``compare`` takes (16, N) planes); the
    cancelling rows' sums must be the identity.  Returns the max |diff|."""
    from bulletproofspp_tpu_torch.ops import curve, kernels

    got = kernels.reduce_lanes(tabs, absd, sgn)
    sel = kernels.select_small(tabs, absd, sgn)
    same_raw(f"{label} against select_small + the padd route", got, tree_route(sel))
    same_raw(f"{label} against select_small + its tree alone", got, kernels.reduce_lanes_tree(sel))
    if int(curve.normalize3(*got)[2, :, :, 1].abs().sum()):
        raise AssertionError(f"{label}: a row of P + (-P) does not sum to the identity")
    return compare(label, tuple(t.reshape(16, -1) for t in got),
                   tuple(t.reshape(16, -1) for t in kernels.reduce_lanes_plain(tabs, absd, sgn)))


def library_remainder(dev, route: str):
    """Phases 15 (b) and 16 (c), one route of REMAINDER_ROUTES (the kernels;
    assemble and reduce_lanes swapped for their plain versions by
    ``engine_profile.plain_versions``, as
    ``engine_profile --plain``: the eager select, with the digits'
    widening, in reduce_lanes_plain):
    ``engine_profile.profile_verify`` and then ``profile_prove`` of
    examples/64bit (on the kernels' route also a prove of each other
    REMAINDER_PROVES example): the device kernels no wrapper of ops.kernels
    launches (``by_wrapper``'s "library": PyTorch's own operators) in ms and
    launches, the four most launched of them, the port's launches, the
    device seconds, the idle share and the wall seconds, logged on one
    line, with the memory copies by kind (``engine_profile.copies``: ms and
    count).  Fails if a profile misses some of the port's launches
    (``engine_profile.profile_complete``) or if a proof is not golden; on
    the kernels' route also if the 64bit prove does not launch
    complete_square, assemble, reduce_lanes and horner or launches endo,
    pneg or padd (its MSMs are all under 128 lanes:
    reduce_lanes selects, horner stores canonical), if the verify's MSM of
    128 lanes does not select in tail_horner, if select_small or normalize3
    launches in a prove or the verify (no MSM launches them), if a prove
    makes more than REMAINDER_MAX library launches (the digits' widening
    was the last), or if a prove or the verify makes a pinned
    host-to-device copy (assemble's tables were the only ones)."""
    from bulletproofspp_tpu_torch import engine_profile
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    proves = REMAINDER_PROVES if route == "kernels" else REMAINDER_PROVES[:1]
    with engine_profile.plain_versions(REMAINDER_ROUTES[route]):
        eng = TorchEngine(dev)
        out = {"verify": engine_profile.profile_verify("64bit", eng),
               "prove": engine_profile.profile_prove("64bit", eng)}
        out.update({f"prove {name}": engine_profile.profile_prove(name, eng)
                    for name in proves[1:]})
    for name in proves:
        step = "prove" if name == proves[0] else f"prove {name}"
        if out[step]["proof_sha256"] != golden()[name][0]:
            raise AssertionError(f"{name} proof bytes on the {route} route are not golden")
    for step, p in out.items():
        if not p["complete"]:
            raise AssertionError(f"the profile of the {route} route's {step} misses some of its "
                                 f"launches {p['launched']}")
    if route == "kernels":
        if not ({"complete_square", *ASSEMBLY_OPS, "horner"} <= set(out["prove"]["launched"])
                and "tail_horner" in out["verify"]["launched"]
                and not set(SQUARE_OPS) & set(out["prove"]["launched"])):
            raise AssertionError(f"the 64bit prove and verify did not launch every square, "
                                 f"assembly and MSM kernel, or launched {SQUARE_OPS}: "
                                 f"{out['prove']['launched']}, {out['verify']['launched']}")
        for step, p in out.items():
            if "HtoD (Pinned -> Device)" in p["copies"]:
                raise AssertionError(f"the {step} made pinned host-to-device copies: "
                                     f"{p['copies']}")
            unfused = {k: p["launched"].get(k, 0) for k in ("select_small", "normalize3")}
            if any(unfused.values()):
                raise AssertionError(f"the {step} launched {unfused}: an MSM selected or "
                                     "normalized in a launch of its own")
            library = p["by_wrapper"]["library"][1]
            if step.startswith("prove") and library > REMAINDER_MAX:
                raise AssertionError(f"the {step} made {library} library launches on the "
                                     f"kernels' route, more than {REMAINDER_MAX}")
    keys = ("library_top", "device_s", "device_idle_share", "wall_s")
    summary = {step: {"library_ms_launches": p["by_wrapper"]["library"], "copies": p["copies"],
                      "port_launches": sum(p["launched"].values()), **{k: p[k] for k in keys}}
               for step, p in out.items()}
    log(f"{card_line()}: library remainder of a 64bit prove and verify"
        f"{''.join(f' and a {n} prove' for n in proves[1:])} (ms, launches), route "
        f"{route} (plain: {', '.join(REMAINDER_ROUTES[route]) or 'none'}): {json.dumps(summary)}")
    return out


def library_remainder_subprocess():
    """Phases 15 (b) and 16 (c): ``library_remainder`` of each route in a
    process of its own, whose profiles are its first (in a process that has
    profiled tens of thousands of launches before, a profile has come back
    without some of the launches it held: PERF.md section 7); their lines
    relayed."""
    for route in REMAINDER_ROUTES:
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, torch, chip_smoke; chip_smoke.library_remainder("
             f"torch.device('cuda'), {route!r}); chip_smoke.require_port_only()"],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            log(line)
        if proc.returncode != 0:
            raise AssertionError(f"the library remainder's process ({route}): rc "
                                 f"{proc.returncode}, stderr {proc.stderr[-2000:]!r}")


def reference_bench_keys(names) -> dict:
    """{function: keys of the JSON line it prints} for the functions
    ``names`` of the JAX package's root bench.py, read from its source (not
    imported)."""
    with open(os.path.join(HERE, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in names:
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                        and node.args and isinstance(node.args[0], ast.Dict)):
                    keys[fn.name] = {k.value for k in node.args[0].keys}
    return keys


def bench_legs_phase(dev):
    """Phase 14: counted from 0 before each, the bench's four proof legs in
    this process at the reference's default sizes on one TorchEngine (the
    batch leg over 1,024 proofs generated now, not a cache); each valid,
    printing the reference's keys, and launching its BENCH_REQUIRED
    kernels.  Then the bench as a subprocess with BENCH_ONLY=batch and
    BENCH_BATCH_N=16.  Returns {path: launches by shape}."""
    from bulletproofspp_tpu_torch import bench
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.ops.engine import TorchEngine

    for name in [k for k in os.environ if k.startswith("BENCH_")]:
        del os.environ[name]  # the reference's default sizes
    want_keys = reference_bench_keys({leg.__name__ for leg, _ in bench.LEGS.values()})
    t0 = time.perf_counter()
    blobs = bench.gen_proofs(BATCH_N)
    log(f"bench legs: {len(blobs)} proofs generated by HostEngine in spawned workers, "
        f"{time.perf_counter() - t0:.3f} s")
    eng = TorchEngine(dev)
    paths = {}
    for name, (leg, valid) in bench.LEGS.items():
        kernels.reset_counts()
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            out = leg(eng, blobs=blobs) if name == "batch" else leg(eng)
        secs = time.perf_counter() - t0
        launches = kernels.counts()
        paths[f"bench_{name}"] = kernels.shape_counts()
        printed = json.loads(err.getvalue().strip().splitlines()[-1])
        log(f"bench leg {name} ({secs:.3f} s): {json.dumps(printed)}")
        log(f"bench leg {name}: launches {json.dumps({k: n for k, n in launches.items() if n})}")
        if printed != out:
            raise AssertionError(f"bench leg {name} printed {printed}, returned {out}")
        if set(out) != want_keys[leg.__name__] | {"card", "power_limit_w"}:
            raise AssertionError(f"bench leg {name}'s keys {sorted(out)} are not the reference's "
                                 f"{sorted(want_keys[leg.__name__])} and the card's")
        if out[valid] is not True:
            raise AssertionError(f"bench leg {name}: {valid} is {out[valid]}")
        require_launched(f"bench leg {name}", launches, BENCH_REQUIRED[name])

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bulletproofspp_tpu_torch.bench"], cwd=HERE, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "BENCH_ONLY": "batch", "BENCH_BATCH_N": str(BENCH_SUBPROCESS_N)})
    lines = [json.loads(t) for t in proc.stderr.splitlines() if t.startswith("{")]
    msm_lines = [t for t in proc.stdout.splitlines() if t.startswith("{")]
    if proc.returncode != 0 or msm_lines or len(lines) != 1 \
            or (lines[0]["batch_n"], lines[0]["batch_all_valid"]) != (BENCH_SUBPROCESS_N, True):
        raise AssertionError(f"BENCH_ONLY=batch: rc {proc.returncode}, stdout {proc.stdout!r}, "
                             f"stderr {proc.stderr[-2000:]!r}")
    log(f"bench BENCH_ONLY=batch BENCH_BATCH_N={BENCH_SUBPROCESS_N} as a subprocess: rc 0, "
        f"{time.perf_counter() - t0:.3f} s, {json.dumps(lines[0])}")
    return paths


def measurement_path():
    """Phase 8: counted from 0, the port's bench at 32,768 points and the
    two tools' mains, all in this process."""
    from bulletproofspp_tpu_torch import bench
    from bulletproofspp_tpu_torch.ops import kernels
    from bulletproofspp_tpu_torch.tools import phase_bench, r5_experiments

    kernels.reset_counts()
    t0 = time.perf_counter()
    out = bench.run()
    log(f"bench ({time.perf_counter() - t0:.3f} s): {json.dumps(out)}")
    if not out["correct"]:
        raise AssertionError("the bench's tabled and untabled MSMs differ from the host answer")
    if not out["iqr_ok"]:
        raise AssertionError(f"a bench IQR stayed above 10% of its median: {out['inner_reps']}")
    if not out["back_to_back"]:
        raise AssertionError("the bench's device times were not back to back")
    for tool in (r5_experiments, phase_bench):
        t0 = time.perf_counter()
        if tool.main() != 0:
            raise AssertionError(f"{tool.__name__} failed")
        log(f"{tool.__name__}: rc 0, {time.perf_counter() - t0:.3f} s")
    launches = kernels.counts()
    require_launched("the measurement path", launches,
                     {"sr_variant", "grid_copy", "chain", "padd", "table_flat", "select_reduce",
                      "reduce_block", "tail_horner"})
    log(f"launches on the measurement path: {launches}")
    return kernels.shape_counts()


def designs(by_shape: dict) -> dict:
    """Launches by design of a kernel that has two: the last word of its
    shapes ("L=16 narrow", "B=1 L=4096 rows")."""
    out = collections.Counter()
    for shape, n in by_shape.items():
        out[shape.split()[-1]] += n
    return dict(out)


def require_port_only():
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "bulletproofspp_tpu"))
    if foreign:
        raise AssertionError(f"modules of JAX or the JAX package were imported: {foreign[:8]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from bulletproofspp_tpu_torch import native
    from bulletproofspp_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    kernels.lib()
    log(f"kernel build + load: {kernels.build_seconds():.3f} s")
    log(f"scalar pipeline: {native.pipeline()}")

    checked = check_kernels(dev)

    work = tempfile.mkdtemp(prefix="bppp_smoke_")
    try:
        kernels.reset_counts()
        by_example = main_path(work)
        launches, cli_shapes = kernels.counts(), kernels.shape_counts()
        log(f"launches on the main path: {launches}")
        require_launched("cli test", launches, set(launches) - {
            "select_reduce_fused", "sr_variant", "grid_copy", "chain", "fold", "inv",
            "to_affine", "select_small", "normalize3", *SQUARE_OPS})
        # the MSMs select in their reductions and store canonical; the square
        # completion makes phi, the negation and both sums in its launch; the
        # one-prover folds are fold_many's (no fold, no table_flat for them)
        unfused = {k: launches[k] for k in ("select_small", "normalize3", "fold", *SQUARE_OPS)}
        if any(unfused.values()):
            raise AssertionError(f"cli test launched {unfused}")
        require_port_only()
        prove_verify_times(work)
        measured = measurement_path()  # before any other torch.profiler session
        wide = msm_wide(dev)
        batch, batch_blobs = batch_1024(dev, work)
        prove_batch, batch_items = prove_batch_phase(dev, work)
        require_launched("prove-batch", {k: sum(v.values()) for k, v in prove_batch.items()},
                         {"complete_square", "horner", "tail_horner", "table_flat", "fold_many",
                          *ASSEMBLY_OPS})
        require_none("prove-batch", prove_batch, (*SQUARE_OPS, "fold"))
        require_port_only()
        served = serve_phase(dev, batch_items)
        require_launched("serve", {k: sum(v.values()) for k, v in served.items()},
                         {"complete_square", "table_flat", "fold_many", "decompress",
                          *ASSEMBLY_OPS})
        require_none("serve", served, (*SQUARE_OPS, "fold"))
        require_port_only()
        multiparty = multiparty_phase(
            dev, work, {k for k, n in by_example[MP_EXAMPLE].items() if n})
        require_port_only()
        shard = sharded_phase(dev, batch_blobs, {
            "padd", "horner", "table_flat", "select_reduce", "select_reduce_fused",
            "reduce_block", "tail_horner", "decompress"})
        require_port_only()
        checked.update(kernel_rows(check_affine(dev)))  # phase 13
        affine = affine_phase(dev)
        require_port_only()
        bench_legs = bench_legs_phase(dev)
        require_port_only()
        checked.update(kernel_rows(check_lane_ops(dev)))  # phase 15
        for name, more in kernel_rows(check_fused_selects(dev, cli_shapes)).items():
            checked[name] = checked.get(name, []) + more  # phase 15 (a')
        checked.update(kernel_rows(check_assembly(dev, cli_shapes)))  # phase 16
        library_remainder_subprocess()
        require_port_only()
    finally:
        os.chdir(HERE)
        shutil.rmtree(work, ignore_errors=True)
    require_port_only()
    paths = {"cli_test": cli_shapes, "msm_2_21": wide, "batch_verify": batch,
             "measurement": measured, "prove_batch": prove_batch, "serve": served,
             "multiparty": multiparty, "sharded": shard, "affine": affine, **bench_legs}
    shapes = {k: collections.Counter() for k in launches}
    for run in paths.values():
        for k, by_shape in run.items():
            shapes[k].update(by_shape)
    launches = {k: sum(v.values()) for k, v in shapes.items()}
    # kernels.OFF_PATH (inv, select_small, pneg, fold): on no path (their
    # launches, the yardsticks of the routes that replaced them, are phase
    # 2's, 13's, 15's and 16's, made outside the counted runs)
    require_launched("the main paths", launches, set(launches) - set(kernels.OFF_PATH))
    off = {k: launches[k] for k in kernels.OFF_PATH if launches[k]}
    if off:
        raise AssertionError(f"kernels off the main paths launched on them: {off}")
    narrow = [sh for sh in shapes["reduce_lanes"] if not 2 <= parse_shape(sh)["L"] < 128]
    if narrow or launches["select_small"]:  # every MSM selects in its first reduction
        raise AssertionError(f"reduce_lanes outside 2-127 lanes {narrow}, select_small "
                             f"{launches['select_small']} launches on the main paths")
    by_path = {k: {path: sum(run[k].values()) for path, run in paths.items()} for k in launches}
    by_design = {k: {path: designs(run[k]) for path, run in paths.items()}
                 for k in ("padd", "table_flat", "reduce_block", "select_reduce")}
    log(f"launches on the main paths by shape: {json.dumps(shapes)}")
    log(f"launches by path: {json.dumps(by_path)}")
    log(f"launches by design and path: {json.dumps(by_design)}")

    report = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"bulletproofspp_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": launches[name],
            "launches_by_path": by_path[name],
            **({"launches_by_design": by_design[name]} if name in by_design else {}),
            "shapes": dict(shapes[name]),
            **row,
        }
        for name, k in kernels.KERNELS.items() for row in checked[name]
    ]}
    log(json.dumps(report))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
