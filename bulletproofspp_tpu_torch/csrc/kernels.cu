// The MSM and basis-fold kernels of the PyTorch port, for Hopper (sm_90a).
//
// padd, horner, reduce_block, tail_horner, table_flat and select_reduce
// each replace one Pallas TPU kernel of bulletproofspp_tpu/ops/pallas_field.py;
// fold replaces the XLA fold_mul_kernel of bulletproofspp_tpu/ops/msm.py,
// fold_many its vmap over the provers of a lockstep batch and, at one
// prover, every fold of the prover and the engine (from the bases' points,
// its lanes' tables built in the launch; with phi, shared_mul's fold of P
// and phi(P)), and fold stays as its yardstick; complete_square the
// square completion around that fold (msm.py:283 and :301: phi, the fold and
// g1 +- r g0 in one launch), and reduce_lanes
// the XLA table select and lane tree of its MSMs under 128 lanes (the
// one-hot select and _reduce_lanes, one program there and one launch here).
// The MSM routes select inside their first reduction: reduce_lanes under 128
// lanes, reduce_block (from 256) or tail_rows (at 128) up to 1,023, with
// select_small's gather (curve.cuh: selected_point); and their last launch,
// horner_warp_kernel, can store the result canonical, which the JAX package
// compiles into the MSM's program (_normalize3).
// All keep the contract: (16, N) int64 planes of 16-bit limbs, strict limbs
// in and out, projective (X:Y:Z) with identity (0:1:0); digits (B, rows, L)
// uint8 planes.  Built by
// ops/kernels.py with nvcc into a shared library with a plain C interface;
// every entry launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that a refused launch is reported.
//
// What bounds them on the H100: integer multiply-add throughput.  One
// complete addition is 12 field products of 64 32x32->64 multiplies each
// plus the carry chains, against 6 x 128 bytes of input and 3 x 128 bytes
// of output per lane: about 1,000 integer operations per 1,152 bytes, far
// above the card's integer-op/byte balance, so the limit is the SMs' IMAD
// rate and the register footprint (a point is 24 words), not memory.  The
// design is the simple one: one thread per independent lane, coalesced
// limb-plane loads (neighbouring threads read neighbouring lanes), 8 x 32-bit
// words in registers, the field arithmetic as Hopper's 32-bit carry chains
// (field.cuh: a product is 64 32 x 32 -> 64-bit multiply-adds on word pairs
// in two chains that do not wait on each other).  Ten are
// designed for this card instead: horner, tail_horner and fold, whose work
// is one chain of dependent point operations per MSM or lane, bound by its
// latency (they run it on a warp: curve_warp.cuh); fold_many, the same
// chain on a group of 16 or 8 threads by the launch's width (below; at 16
// each product of a round on two threads: curve_warp.cuh), and
// complete_square, fold_many's launch with phi before it and two additions
// after; padd, table_flat,
// reduce_block and reduce_lanes, which at the narrow widths most of their
// calls have (16 to a few thousand lanes) fill few SMs and wait on one
// thread's additions, so (below a lane count, or always for reduce_lanes)
// they run each addition on a group of kNarrowGroup threads
// (curve_warp.cuh; reduce_block and reduce_lanes by the levels of their
// halving trees, so an output lane waits on log2 F additions, not F - 1;
// reduce_lanes hands a level's sums on through registers, shuffles and
// named barriers instead of block-wide barriers)
// and keep the one-thread body for wide calls; and select_reduce, whose digit-chosen
// reads cost more than its adds until its lanes' tables stay close for all
// rows: in shared memory, or in L2 (below).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "curve.cuh"
#include "curve_warp.cuh"
#include "select_reduce.cuh"

using namespace bppp;

namespace {

constexpr int kThreads = 128;
// The narrow designs' group: the narrowest that holds an addition's 6
// products a round, so a warp carries 4 lanes for the instructions of one
// (groups of 16 and 32 were slower on the H100 from 2,048 lanes).
constexpr int kNarrowGroup = 8;
constexpr int kNarrowLanes = kThreads / kNarrowGroup;  // lanes a block

inline int blocks_for(int64_t n, int per_block = kThreads) {
  int64_t b = (n + per_block - 1) / per_block;
  return (int)(b > 65535 * 16 ? 65535 * 16 : b);
}

// --- padd: replaces padd_pallas / _kernel (pallas_field.py:759, :407) -----
// Lane-wise complete addition.  Two designs, the same words (the wrapper,
// ops/kernels.py: padd, picks by lane count).  padd_kernel, wide: one
// thread per lane, instantiated for 128, 256, 512 and 1,024 threads a block
// (the counterpart of padd_pallas's block= sweep, tools/r5_experiments.py
// H1); __launch_bounds__ caps the registers so that a block of MAXT threads
// fits an SM.
template <int MAXT>
__global__ void __launch_bounds__(MAXT) padd_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
                            const int64_t* __restrict__ z1, const int64_t* __restrict__ x2,
                            const int64_t* __restrict__ y2, const int64_t* __restrict__ z2,
                            int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                            int64_t* __restrict__ oz, int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    Pt p = pt_load(x1, y1, z1, n, j);
    Pt q = pt_load(x2, y2, z2, n, j);
    pt_store(ox, oy, oz, n, j, pt_add(p, q));
  }
}

// The narrow design, for the halving trees of MSMs under 128 lanes and
// complete_square (16 to a few thousand lanes): one lane per group of
// kNarrowGroup threads, its addition in 2 rounds of 6 products
// (pt_add_warp), the result's 24 words stored by the group
// (fe_store_group).  A block carries kNarrowLanes lanes; the loop is
// uniform over the block, and a group past the last lane computes lane
// n - 1 again and stores nothing (every thread takes part in the shuffles).
__global__ void __launch_bounds__(kThreads)
    padd_narrow_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
                       const int64_t* __restrict__ z1, const int64_t* __restrict__ x2,
                       const int64_t* __restrict__ y2, const int64_t* __restrict__ z2,
                       int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                       int64_t* __restrict__ oz, int64_t n) {
  for (int64_t j0 = blockIdx.x * (int64_t)kNarrowLanes; j0 < n;
       j0 += (int64_t)gridDim.x * kNarrowLanes) {
    const int64_t j = j0 + threadIdx.x / kNarrowGroup, jl = j < n ? j : n - 1;
    const Pt r = pt_add_warp<kNarrowGroup>(pt_load(x1, y1, z1, n, jl),
                                           pt_load(x2, y2, z2, n, jl));
    if (j < n) {
      int64_t* const dst[3] = {ox, oy, oz};
      const Fe v[3] = {r.x, r.y, r.z};
      fe_store_group<kNarrowGroup>(dst, v, n, j);
    }
  }
}

// Sum F points in the Pallas kernels' halving order (pairs m, m + F/2
// first, then m, m + F/4, ...) into v[0].
template <int F>
__device__ __forceinline__ void halve(Pt* v) {
#pragma unroll
  for (int h = F / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int m = 0; m < h; m++) v[m] = pt_add(v[m], v[m + h]);
  }
}

// Where a reduction's first level finds its operands: lane j of (16, w)
// planes, or, with FromTables, selected point j of table_flat's flat tables
// of n = B L lanes and the (B, rows, L) uint8 digits (w = B rows L;
// curve.cuh: selected_point, select_small_kernel's words).  So the MSM
// routes of 128 to 1,023 lanes select inside the launch that reduces: the
// selected points (B rows L x 384 B) never reach device memory.
template <bool FromTables>
struct Operands {
  const int64_t *x, *y, *z;   // planes, or the tables tx, ty2, tz
  const uint8_t *absd, *sgn;  // FromTables: the digits
  int64_t w, n, rows, L;      // lanes; FromTables: table lanes, rows, lanes an MSM
  __device__ __forceinline__ Pt operator()(int64_t j) const {
    if constexpr (FromTables) {
      return selected_point(x, y, z, absd, sgn, n, rows, L, j);
    } else {
      return pt_load(x, y, z, w, j);
    }
  }
};

// --- reduce_block: replaces reduce_block_pallas / _reduce_block_kernel -----
// (:490, :474).  Narrows (16, W) by F within blocks of 128 * F lanes: output
// lane t of block k sums input lanes k*128F + t + m*128, m < F, in the Pallas
// kernel's halving order (at level h = F/2, F/4, ..., 1 pair m with m + h),
// so the projective outputs match it limb for limb.  With FromTables the
// input lanes are the points the digits select (Operands), the first
// launch of the MSM route from 256 to 1,023 lanes, so the words equal
// select_small + the kernel on its output.  Two designs, the same words (the
// wrapper, ops/kernels.py: reduce_block, picks by output lanes a call):
//  * reduce_block_kernel, wide: one thread per output lane, its F - 1
//    additions one after another (12 (F - 1) dependent products: 84 at F =
//    8).  For the wide calls, where one thread a lane fills the card.
//  * reduce_block_narrow_kernel, narrow: the tree by levels, each addition
//    of a level on one group of kNarrowGroup threads (pt_add_warp<8>: 2
//    rounds of 6 products), so an output lane waits on log2 F additions, 2
//    log2 F rounds.  For the narrow calls (a few thousand output lanes:
//    cli test's MSMs, the bench's second launch), where the wide design
//    fills a few dozen blocks and waits on its chain.
template <int F, bool FromTables>
__global__ void reduce_block_kernel(const Operands<FromTables> in, int64_t* __restrict__ ox,
                                    int64_t* __restrict__ oy, int64_t* __restrict__ oz) {
  const int64_t n_out = in.w / F;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n_out;
       j += (int64_t)gridDim.x * blockDim.x) {
    int64_t base = (j / 128) * (128 * F) + (j % 128);
    Pt v[F];
#pragma unroll
    for (int m = 0; m < F; m++) v[m] = in(base + m * 128);
    halve<F>(v);
    pt_store(ox, oy, oz, n_out, j, v[0]);
  }
}

// Output lanes a block of the narrow design carries: its kNarrowLanes
// groups hold the first level's F / 2 additions of each.
template <int F>
constexpr int kReduceOuts = kNarrowLanes / (F / 2);

// Group g of a block runs addition g of each level: pair m = g / outs of
// output lane i = g % outs (outs = kReduceOuts<F>), so a level's outs * h
// additions sit on the first groups (a multiple of a warp's 4: a warp has
// all or none of them, and one without skips the level on a uniform
// branch), and a warp's groups hold neighbouring output lanes: its loads
// and stores touch 4 neighbouring lanes of a limb row, one 32-byte sector.
// The first level reads its operands from device memory (with FromTables
// by digit from the tables); each level leaves addition g's sum in slot g
// of shared memory, where addition g of level h finds its two operands
// (slots g and g + outs * h); the last level's groups store the output
// lanes (fe_store_group).  n_out = W / F is a multiple of 128, so every
// block is whole.
template <int F, bool FromTables>
__global__ void __launch_bounds__(kThreads)
    reduce_block_narrow_kernel(const Operands<FromTables> in, int64_t* __restrict__ ox,
                               int64_t* __restrict__ oy, int64_t* __restrict__ oz) {
  constexpr int outs = kReduceOuts<F>;
  constexpr int groups_a_warp = 32 / kNarrowGroup;
  __shared__ Pt sums[kNarrowLanes];
  const int g = threadIdx.x / kNarrowGroup, first = threadIdx.x / 32 * groups_a_warp;
  const int i = g % outs, m = g / outs;
  const int64_t n_out = in.w / F;
  for (int64_t j0 = blockIdx.x * (int64_t)outs; j0 < n_out; j0 += (int64_t)gridDim.x * outs) {
    const int64_t j = j0 + i, base = (j / 128) * (128 * F) + j % 128;
    Pt s = pt_add_warp<kNarrowGroup>(in(base + m * 128), in(base + (m + F / 2) * 128));
#pragma unroll
    for (int h = F / 4; h >= 1; h /= 2) {
      sums[g] = s;  // the 8 threads of a group write the same words
      __syncthreads();
      if (first < outs * h) {
        const Pt a = sums[g], b = sums[g + outs * h];
        s = pt_add_warp<kNarrowGroup>(a, b);
      }
      __syncthreads();  // every read of this level before the next writes
    }
    if (g < outs) {
      int64_t* const dst[3] = {ox, oy, oz};
      const Fe v[3] = {s.x, s.y, s.z};
      fe_store_group<kNarrowGroup>(dst, v, n_out, j);
    }
  }
}

// --- reduce_lanes: replaces msm_kernel under 128 lanes up to its Horner
// step (bulletproofspp_tpu/ops/msm.py:105-184): the one-hot select of
// msm._table's entries (:140-156) and _reduce_lanes (:81, :176), which XLA
// compiles into one program.  Input: table_flat's flat tables of B L lanes
// and the (B, rows, L) digits, L a power of two under 128; output (16, B,
// rows) row sums for horner.  The first level gathers its two operands by
// digit straight from the tables (curve.cuh: selected_point, X and Z entry
// |d|, Y entry |d| + 9 s: select_small_kernel's words), so the selected
// points never reach device memory.  With `from_tables` 0 it reads them from a (16, B, rows, L) plane
// instead (the tree alone, for the smoke's comparison with select_small +
// this tree).  The tree is the one the padd kernel ran level by level (pair
// q's lane t plus lane t + h, h = L / 2, L / 4, ..., 1), so the words equal
// select_small + that route's; the JAX package's radix-8 order adds other
// pairs (equal after affine conversion).
//
// What bounds it: the latency of log2 L dependent additions (1-6 levels of
// 2 product rounds), far from the multiplies and the bytes.  Each level
// costs one addition's latency on a warp (~2.6 us on the H100 at B = 2, L =
// 32); the design removes what a tree by levels through shared memory and
// block-wide barriers adds on top of it, and the selected points' round
// trip through device memory:
//  * one (MSM, row) pair a block from L = 8 (L / 2 groups of kNarrowGroup
//    threads, 4 L threads), 8 / L pairs in one warp below: all of a pair's
//    first-level additions at once, and as many blocks as pairs (66 at B =
//    2, 33 rows: half the SMs; more pairs a block would leave SMs idle);
//  * the first level loads both operands' 96 limbs (after the 4 digits) and
//    only then starts its first product;
//  * a level's sum stays in its group's registers: of each addition's two
//    operands the first is the group's own sum, the second comes from the
//    group h above: through shared memory and a named barrier over the
//    warps that still take part (bar.sync with their count) where that
//    group is in another warp (h >= 4 groups), by __shfl_down_sync where it
//    is in the same warp (the last two levels).  Warps whose groups are done
//    leave; no level waits on a block-wide __syncthreads.
// `levels` < log2 L stops after that many levels and stores each pair's
// lane-0 partial sum (the smoke's per-level timing).
template <int L>
__global__ void __launch_bounds__(L >= 8 ? 4 * L : 32)
    reduce_lanes_kernel(const int64_t* __restrict__ tx, const int64_t* __restrict__ ty2,
                        const int64_t* __restrict__ tz, const uint8_t* __restrict__ absd,
                        const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                        int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t batch,
                        int64_t rows, int levels, int from_tables) {
  constexpr int half = L / 2, per = L >= 8 ? 1 : 8 / L;  // groups a pair, pairs a block
  __shared__ Pt slot[half >= 8 ? half : 1];
  const int g = threadIdx.x / kNarrowGroup, p = g / half, t = g % half;
  const int wfirst = threadIdx.x / 32 * (32 / kNarrowGroup);  // the warp's first group
  const int64_t pairs = batch * rows, q = blockIdx.x * (int64_t)per + p;
  const int64_t qc = q < pairs ? q : pairs - 1;  // a pair past the last repeats it
  Pt a, b;  // the level's two operands: the group's own sum and the one h groups above
  if (from_tables) {
    const int64_t n = batch * L, j = qc * L + t;
    a = selected_point(tx, ty2, tz, absd, sgn, n, rows, L, j);
    b = selected_point(tx, ty2, tz, absd, sgn, n, rows, L, j + half);
  } else {
    const int64_t m = pairs * L, j = qc * L + t;
    a = pt_load(tx, ty2, tz, m, j);
    b = pt_load(tx, ty2, tz, m, j + half);
  }
  // Not unrolled: one copy of the addition's code for every level, so a
  // level after the first runs from a warm instruction cache (unrolled,
  // each level's copy was fetched cold: 8-10 us a level on the H100).
  Pt s;
#pragma unroll 1
  for (int h = half, level = 1;; h /= 2, level++) {
    s = pt_add_warp<kNarrowGroup>(a, b);
    if (h == 1 || level == levels) break;
    const int hn = h / 2;
    if (hn >= 4) {  // the partner group is in another warp (per == 1 here)
      if (wfirst >= 2 * hn) return;  // done at an earlier level
      if (t >= hn) slot[t] = s;  // the 8 threads of a group write the same words
      asm volatile("bar.sync %0, %1;" ::"r"(1 + level), "r"(16 * hn) : "memory");
      if (t >= hn) return;  // whole warps: hn is a multiple of a warp's 4 groups
      b = slot[t + hn];
    } else {  // in this warp: every thread takes part in the shuffles
      if (wfirst >= 4) return;
#pragma unroll
      for (int k = 0; k < 8; k++) {
        b.x.w[k] = __shfl_down_sync(0xffffffffu, s.x.w[k], kNarrowGroup * hn);
        b.y.w[k] = __shfl_down_sync(0xffffffffu, s.y.w[k], kNarrowGroup * hn);
        b.z.w[k] = __shfl_down_sync(0xffffffffu, s.z.w[k], kNarrowGroup * hn);
      }
    }
    a = s;
  }
  if (t == 0 && q < pairs) {
    int64_t* const dst[3] = {ox, oy, oz};
    const Fe v[3] = {s.x, s.y, s.z};
    fe_store_group<kNarrowGroup>(dst, v, pairs, q);
  }
}

// --- tail_horner: replaces tail_horner_pallas / _tail_horner_kernel --------
// (:742, :711), and horner: replaces horner_pallas / _horner_kernel (:446,
// :419).  tail_horner: input (16, batch, rows * 128), output (16, batch), in
// two launches; horner: input (16, batch, rows) row sums, output (16,
// batch), in one.  The function is a chain: each row's 128 lanes halve
// (pairs t, t + 64, then t, t + 32, ... : the order of the Pallas kernel's
// roll levels), then Horner runs over the row sums, 4 doublings and 1
// addition a row.  It is bound by the latency of that chain, not by bytes
// or multiplies, so the design shortens the chain:
//  * tail_rows_kernel: one block of kTailThreads threads per (MSM, row),
//    all rows at once, the row sum to a (16, batch, rows) scratch.  With
//    FromTables its input lanes are the points the digits select from the
//    tables (Operands): the MSM route of 128 lanes selects here, and the
//    words equal select_small + the plane route.  The tree runs by levels,
//    each addition on a group of kTailGroup threads (pt_add_warp: 2 rounds
//    of 6 products, where one thread runs 12 products one after another).
//    The block is kTailGroups groups, not one group for each of the first
//    level's 64 additions: group g runs the first level's additions g and
//    g + 32 in turn; from the second level (h = 32, 16, ... 1 additions)
//    addition g reads slots g and g + h of shared memory, where each
//    addition leaves its sum, and warps without an addition of the level
//    skip it.  No point lives in registers across the levels, so a thread
//    fits 128 registers and an SM two blocks (__launch_bounds__; at one
//    block an SM, 153 registers, 4,290 row trees took 1.4x as long).  One
//    loop of 8 additions, so the addition's code is one copy (an unrolled
//    copy a level was fetched cold, reduce_lanes_kernel's note);
//  * horner_warp_kernel, tail_horner's second launch and horner's only one:
//    one warp per MSM runs Horner over the row sums with the
//    warp-cooperative addition and doubling of curve_warp.cuh (10 rounds of
//    one field product each a row, where one thread would run 44 products),
//    each product of a round on kHornerSplit threads (fe_mul_split: 12 of
//    the 32 threads in an addition's round, 8 in a doubling's).
//    With Canon, lanes 0-2 store fe_canon of X, Y and Z (ox, oy and oz the
//    three planes of a stacked (3, 16, batch) tensor): every MSM's result
//    leaves the route canonical, ready for one device-to-host copy, with no
//    normalize3 launch after it (the JAX package compiles _normalize3 into
//    the MSM's program).  The words equal normalize3 of the plain stores.
constexpr int kTailGroup = 8;
constexpr int kTailThreads = 256;
constexpr int kTailGroups = kTailThreads / kTailGroup;
// threads a product of horner's rounds (tools/phase_bench.py on one warp,
// H100: a Horner round 0.49 us at 1, 0.40 at 2)
constexpr int kHornerSplit = 2;

template <bool FromTables>
__global__ void __launch_bounds__(kTailThreads, 2) tail_rows_kernel(const Operands<FromTables> in,
                                                                    int64_t* __restrict__ rx,
                                                                    int64_t* __restrict__ ry,
                                                                    int64_t* __restrict__ rz,
                                                                    int64_t n_rows) {
  static_assert(2 * kTailGroups == 64, "two of the first level's additions a group");
  __shared__ Pt sums[64];
  const int g = threadIdx.x / kTailGroup;
  const int wfirst = threadIdx.x / 32 * (32 / kTailGroup);  // the warp's first group
  const int64_t br = blockIdx.x;  // b * rows + r
  const int64_t base = br * 128;
#pragma unroll 1
  for (int i = 0; i < 8; i++) {
    const int h = 128 >> i;  // from i = 2: this level's additions, 32 .. 1
    Pt a, b;
    if (i < 2) {  // the first level's addition g + 32 i
      a = in(base + g + 32 * i);
      b = in(base + g + 32 * i + 64);
    } else {
      __syncthreads();  // every sum of the level before written
      if (wfirst < h) {  // g + h < 64 in every warp that has an addition
        a = sums[g];
        b = sums[g + h];
      }
      __syncthreads();  // every read of this level before its writes
      if (wfirst >= h) continue;  // whole warps: a uniform branch
    }
    const Pt s = pt_add_warp<kTailGroup>(a, b);
    sums[g + 32 * (i == 1)] = s;  // the 8 threads of a group write the same words
    if (i == 7 && g == 0) {
      int64_t* const dst[3] = {rx, ry, rz};
      const Fe v[3] = {s.x, s.y, s.z};
      fe_store_group<kTailGroup>(dst, v, n_rows, br);
    }
  }
}

template <bool Canon>
__global__ void __launch_bounds__(32) horner_warp_kernel(
    const int64_t* __restrict__ rx, const int64_t* __restrict__ ry,
    const int64_t* __restrict__ rz, int64_t* __restrict__ ox, int64_t* __restrict__ oy,
    int64_t* __restrict__ oz, int64_t batch, int64_t rows) {
  extern __shared__ Pt rowsum[];  // rows
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  for (int64_t r = lane; r < rows; r += 32) rowsum[r] = pt_load(rx, ry, rz, batch * rows, b * rows + r);
  __syncwarp();
  const Pt acc = horner_rows_warp<kHornerSplit>(rowsum, rows);
  if constexpr (Canon) {
    if (lane < 3) {  // coordinate `lane`, picked by selects (no local memory)
      const Fe v[3] = {acc.x, acc.y, acc.z};
      fe_store(lane == 0 ? ox : lane == 1 ? oy : oz, batch, b, fe_canon(fe_pick(v, lane)));
    }
  } else if (lane == 0) {
    pt_store(ox, oy, oz, batch, b, acc);
  }
}

// --- table_flat: replaces table_flat_pallas / _table_flat_kernel -----------
// (:538, :515).  Per lane the multiples 0P..8P (7 complete additions) and
// the 9 negated Y, in the flat layout the select and fold kernels read:
// entry e, limb i, lane j at (16 e + i) * n + j, so tx and tz are (144, n)
// and ty2 is (288, n) (entries 9..17 hold -Y of 0P..8P).  Each entry is
// stored as soon as it is made.  Two designs, the same words (the wrapper,
// ops/kernels.py: table_flat, picks by lane count):
//  * table_flat_kernel, wide: one thread per lane, 84 products one after
//    another.  Near the card's rate of additions once the lanes fill it
//    (msm_many's stacked tables, the bench's 65,536 lanes).
//  * table_flat_narrow_kernel, narrow: one lane per group of kNarrowGroup
//    threads, the 7 additions in 14 rounds of 6 products (pt_add_warp); the
//    group shares each entry's 64 limb rows of stores (fe_store_group).  For the
//    16-4,096 lanes of fold's and the small MSMs' tables, where the wide
//    design fills a few SMs and waits on its chain.
__global__ void table_flat_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                                  const int64_t* __restrict__ pz, int64_t* __restrict__ tx,
                                  int64_t* __restrict__ ty2, int64_t* __restrict__ tz,
                                  int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    Pt base = pt_load(px, py, pz, n, j);
    Pt acc = pt_identity();
    for (int e = 0; e < 9; e++) {
      if (e == 1) acc = base;
      if (e > 1) acc = pt_add(acc, base);
      fe_store(tx + 16 * e * n, n, j, acc.x);
      fe_store(ty2 + 16 * e * n, n, j, acc.y);
      fe_store(ty2 + 16 * (e + 9) * n, n, j, fe_neg(acc.y));
      fe_store(tz + 16 * e * n, n, j, acc.z);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    table_flat_narrow_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                             const int64_t* __restrict__ pz, int64_t* __restrict__ tx,
                             int64_t* __restrict__ ty2, int64_t* __restrict__ tz, int64_t n) {
  for (int64_t j0 = blockIdx.x * (int64_t)kNarrowLanes; j0 < n;
       j0 += (int64_t)gridDim.x * kNarrowLanes) {
    const int64_t j = j0 + threadIdx.x / kNarrowGroup, jl = j < n ? j : n - 1;
    const Pt base = pt_load(px, py, pz, n, jl);
    Pt acc = pt_identity();
#pragma unroll 1
    for (int e = 0; e < 9; e++) {
      if (e == 1) acc = base;
      if (e > 1) acc = pt_add_warp<kNarrowGroup>(acc, base);
      if (j < n) {
        int64_t* const dst[4] = {tx + 16 * e * n, ty2 + 16 * e * n, ty2 + 16 * (e + 9) * n,
                                 tz + 16 * e * n};
        const Fe v[4] = {acc.x, acc.y, fe_neg(acc.y), acc.z};
        fe_store_group<kNarrowGroup>(dst, v, n, j);
      }
    }
  }
}

// --- select_reduce: replaces select_reduce_pallas / _select_reduce_kernel --
// (:679, :647).  Flat tables of batch * L lanes, digits absd/sgn (batch,
// rows, L); output (16, batch * rows * L / 8) row-major partials: for MSM b,
// row r and lane block k of 1,024, output lane t < 128 sums the entries
// selected by the digits of lanes k*1024 + t + m*128, m < 8, in the halving
// order of the Pallas kernel (m with m + 4, then m + 2, then m + 1).
//
// What bounds it: its adds (7 a partial, 1.9 M at 65,536 lanes and 33 rows),
// once the selection is cheap.  A gather with one thread per output and the
// rows outermost in the grid takes more time for the selection than for
// the adds: a sector of a digit-chosen plane
// serves about one thread, and each row streams the whole table (4,608 B a
// lane, 302 MB at 65,536 lanes: six times L2) through L2 again.  Two
// designs; the wrapper (ops/kernels.py: select_reduce) takes the staged one
// from STAGE_MIN_LANES = 65,536 lanes a call, where it was 2-12% the faster
// on the H100 (tools/r5_experiments.py H5, up to prove's 130 MSMs of 4,096
// lanes), and the gather below:
//  * select_reduce_kernel, staged: the F = 8, blk 1,024, out 128 instance
//    of select_reduce.cuh's staged row phase (sr_staged, which the tools'
//    sr_variant shares): each block first stages its 128 lanes' entries
//    1..8 into shared memory in coalesced 16-byte reads, then runs sr_rows
//    over all rows.  Each lane's table leaves device memory once for all
//    rows.
//  * select_reduce_rows_kernel, the gather: one thread per output, the grid
//    reordered so that the rows of a lane block run in consecutive blocks
//    and the lane block's table (4.7 MB) stays in L2 across its rows.
//    Where the lanes fill few blocks, staging a block's table costs more
//    than gathering from L2.
__global__ void __launch_bounds__(kSrThreads<8>, 2)
    select_reduce_kernel(const int64_t* __restrict__ tx, const int64_t* __restrict__ ty2,
                         const int64_t* __restrict__ tz, const uint8_t* __restrict__ absd,
                         const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                         int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t batch,
                         int64_t rows, int64_t L) {
  extern __shared__ u32 tab[];  // [entry 1..8][24 words][128 lanes]
  sr_staged<8, false>(tab, tx, ty2, tz, absd, sgn, ox, oy, oz, batch, rows, L, 128);
}

// Output o over (b, k, r, t): 128 outputs t of lane block k and row r a
// block of 128 threads.
__global__ void select_reduce_rows_kernel(const int64_t* __restrict__ tx,
                                          const int64_t* __restrict__ ty2,
                                          const int64_t* __restrict__ tz,
                                          const uint8_t* __restrict__ absd,
                                          const uint8_t* __restrict__ sgn,
                                          int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                                          int64_t* __restrict__ oz, int64_t batch, int64_t rows,
                                          int64_t L) {
  const int64_t n = batch * L, nblk = L / 1024, per_row = L / 8, n_out = batch * rows * per_row;
  for (int64_t o = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; o < n_out;
       o += (int64_t)gridDim.x * blockDim.x) {
    const int64_t t = o % 128, r = (o / 128) % rows, k = (o / (128 * rows)) % nblk;
    const int64_t b = o / (128 * rows * nblk), br = b * rows + r;
    const int64_t lane0 = k * 1024 + t;
    auto load = [&](int m) {
      const int64_t l = lane0 + m * 128;
      return table_entry(tx, ty2, tz, n, b * L + l, absd[br * L + l], sgn[br * L + l]);
    };
    pt_store(ox, oy, oz, n_out, br * per_row + k * 128 + t, halving_tree<8>(load, 0, 1));
  }
}

// --- fold: replaces the XLA fold_mul_kernel (bulletproofspp_tpu/ops/msm.py:247)
// Per lane b E_j + a O_j with digit streams shared by all lanes (basis
// folding and square completion): 33 rows of 4 doublings and 2 additions,
// MSB row first, the entries read from the lanes' flat tables (table_flat's
// layout).  A row r makes s_r = E entry + O entry, then acc = 16 acc + s_r
// (the JAX scan adds the two entries to acc one after the other, the same
// group element: the projective words differ, the affine point does not).
//
// What bounds it: the latency of its chain, 198 dependent point operations
// a lane, at the 16-512 lanes the prover folds (far below both the
// multiplies and the bytes bounds).  So one warp runs one lane's chain with
// the warp-cooperative doubling and addition of curve_warp.cuh (2 rounds
// of independent field products each: 396 rounds, not 1,848 products on
// one thread), the accumulator replicated in every lane's registers, and a
// block holds 4 warps, so 512 lanes spread over 128 SMs.  The digits are
// uniform over the grid: they travel by value in the launch (FoldDigits,
// 132 bytes the wrapper packs on the host; no upload, no synchronization),
// and every lane of a warp reads the same entry's limbs (a broadcast), the
// next row's entries issued before that row's doublings.
constexpr int kFoldRows = 33;  // ops/glv.py: ROWS
constexpr int kFoldWarps = 4;

struct FoldDigits {
  uint8_t d[4][kFoldRows];  // de, se, do, so
};

// One warp a lane: the loop is uniform over the warp.
__global__ void __launch_bounds__(32 * kFoldWarps)
    fold_kernel(const int64_t* __restrict__ ex, const int64_t* __restrict__ ey2,
                const int64_t* __restrict__ ez, const int64_t* __restrict__ ox,
                const int64_t* __restrict__ oy2, const int64_t* __restrict__ oz,
                const __grid_constant__ FoldDigits dig, int64_t* __restrict__ rx,
                int64_t* __restrict__ ry, int64_t* __restrict__ rz, int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)kFoldWarps + threadIdx.x / 32; j < n;
       j += (int64_t)gridDim.x * kFoldWarps) {
    Pt acc = pt_identity();
#pragma unroll 1
    for (int r = 0; r < kFoldRows; r++) {
      const Pt e = table_entry(ex, ey2, ez, n, j, dig.d[0][r], dig.d[1][r]);
      const Pt o = table_entry(ox, oy2, oz, n, j, dig.d[2][r], dig.d[3][r]);
#pragma unroll 1
      for (int k = 0; k < 4; k++) acc = pt_dbl_warp(acc);
      acc = pt_add_warp(acc, pt_add_warp(e, o));
    }
    if ((threadIdx.x & 31) == 0) pt_store(rx, ry, rz, n, j, acc);
  }
}

// --- fold_many: replaces jax.vmap(fold_mul_kernel) (bulletproofspp_tpu/ops/
// msm.py:297) and its use in jax.vmap(_csq_with_endo) (:306): fold over B
// provers at once, each with its own digit streams, for the lockstep prover.
// Its input is the JAX function's: the two bases' strict projective points,
// (16, B L) planes with prover b's L lanes at b L; each lane's two multiple
// tables are built in the launch, as fold_mul_kernel builds them (_table).
//
// What bounds it on the H100, by the launch's width (its lanes: 32 at B = 2,
// L = 16 to 8,192 at B = 16, L = 512):
//  * narrow launches: the latency of a lane's chain, 4 doublings and 1
//    addition a row over 33 rows (330 product rounds on a group of
//    threads: each row's sum of its two entries is made beside the row
//    before, fold_rows), after the tables' 7 additions each.  The tables
//    are built here, not by two table_flat launches before (two launches, and 4,608 B
//    a lane written to device memory and read back row by row as int64
//    limbs): the lane's group loads E_j and O_j once, makes the 9 multiples
//    of each with table_flat_narrow_kernel's formulas in its order (so each
//    entry is table_flat's, word for word) and keeps them as packed words in
//    shared memory, X, Y, -Y and Z of each (FoldEntry: 2 x 36 x 32 B = 2,304
//    B a lane); each row then reads its E and O entries from there.  With a
//    group of 16 or 32 threads the two tables are built at once, each by
//    half of the group (7 additions, not 14).
//  * wide launches: instruction issue.  In a round of curve_warp.cuh every
//    thread of the group issues the round's product or a copy of it (an
//    addition has 6, a doubling 4) and all the cheap steps, so a warp a lane
//    (G = 32) issues 32 threads' instructions for one lane's work: at 8,192
//    warps each scheduler carries ~16 and the rounds queue behind each
//    other.  A group of G = 8 threads holds an addition's 6 products, and a
//    warp then carries 4 lanes for the same instructions: a quarter of the
//    issue a lane.
// So the kernel is instantiated for G = 8, 16 and 32, and the wrapper
// (ops/kernels.py: fold_many) takes G = 8 from FOLD_MANY_WIDE_LANES (2,048)
// lanes a launch and G = 16 below, where it matched G = 32 within 0.6% and
// was the fastest at 1,024 lanes (chip_smoke.py phase 2 times all three in
// turns at five shapes).  The order of each lane's chain is fold's: per
// row the sum of the E and O entries, then 4 doublings and + that sum; the
// output equals table_flat + fold on the same lanes word for word, whatever
// G.  Up to kFoldMaxProvers provers' digits travel by value in the launch
// (no upload, no synchronization); the wrapper splits a call of more
// provers into launches of at most that many, each over its provers' lanes.
constexpr int kFoldMaxProvers = 16;  // ops/kernels.py: FOLD_MAX_PROVERS

struct FoldDigitsMany {
  FoldDigits p[kFoldMaxProvers];
};

// a kernel's parameters may take 4 KB: the digits, fold_many's nine
// pointers and its four int64s
static_assert(sizeof(FoldDigitsMany) == kFoldMaxProvers * 4 * kFoldRows,
              "FoldDigitsMany must be 16 provers' 132 bytes, packed");
static_assert(sizeof(FoldDigitsMany) + 13 * sizeof(int64_t) <= 4096,
              "fold_many's parameters must fit in 4 KB");

// Entry e of a lane's table of one basis, in shared memory.
struct __align__(16) FoldEntry {
  Fe x, y, ny, z;  // ny = -y (fe_neg), as table_flat's entries 9..17
};

// Lanes a block of fold_many at group width G: 36,864 B of tables at G = 8
// (and 1,536 B of fold_rows' stash), within the 48 KB of static shared
// memory.
template <int G>
constexpr int kFoldManyLanes = 32 * kFoldWarps / G;

// The 9 multiples of `base` on a group of H threads, in table_flat's order
// (0P, P, then + P), stored to t[0..8] (the H threads write the same words).
template <int H>
__device__ __forceinline__ void fold_table(FoldEntry* t, const Pt& base) {
  Pt acc = pt_identity();
#pragma unroll 1
  for (int e = 0; e < 9; e++) {
    if (e == 1) acc = base;
    if (e > 1) acc = pt_add_warp<H>(acc, base);
    t[e].x = acc.x;
    t[e].y = acc.y;
    t[e].ny = fe_neg(acc.y);
    t[e].z = acc.z;
  }
}

// Entry |d| of a table, -Y where s is 1.
__device__ __forceinline__ Pt fold_entry(const FoldEntry* t, int d, int s) {
  const FoldEntry& en = t[d];
  Pt p;
  p.x = en.x;
  p.y = *(s ? &en.ny : &en.y);
  p.z = en.z;
  return p;
}

// The half of its group a thread is in: at G >= 16 each half builds one of
// the lane's two tables, makes one of fold_rows' two additions a row (and
// complete_square's halves make one of its two sums each); at G = 8 the
// whole group does both in turn.
template <int G>
__device__ __forceinline__ int fold_half() {
  return G >= 16 ? (threadIdx.x / (G / 2)) & 1 : 0;
}

// The lane's fold on its group of G threads, after its two tables are in
// t (t[0] E's, t[1] O's): per row r the sum s_r = E entry + O entry, then
// 4 doublings and acc + s_r (fold's order).  s_r does not depend on acc, so
// at G >= 16 it leaves the chain: the group's two halves run one addition
// each, on G / 2 threads (curve_warp.cuh: pt_add_pair), half 0 acc + s_r
// while half 1 makes s_(r+1) from the next row's entries (the last row's
// half 1 makes s_32 again, unread), and the two sums cross halves by
// shuffles.  A row's chain is 4 doublings on the whole group, each product
// on two threads (curve_warp.cuh: fe_mul_split), and one addition, not
// two.  Both halves issue the same instructions, so nothing diverges.  s_0
// is made by a pass of the loop before row 0 (no doublings, half 0's sum
// dropped) rather than by a copy of the addition before the loop: on the
// H100 that copy made fold_many 1.3% slower at B = 1, L = 16 and
// complete_square 15% (its round ~10% slower than fold_many's, as before
// the paired addition; with the pass the two are within 1%).  At G = 8
// (wide launches, bound by instruction issue; an addition's 12 threads
// would not fit) the group makes the doublings, s_r and acc + s_r in turn,
// one product a thread; acc waits in shared memory (stash, the lane's)
// while the group makes s_r, so that it holds no more registers than an
// addition to acc does (136 registers a thread with acc in them, and three
// blocks an SM instead of four: 6% slower at 8,192 lanes).  Every thread
// of the group ends with the sum; the words are the same whatever G.
template <int G>
__device__ __forceinline__ Pt fold_rows(const FoldEntry (&t)[2][9], const FoldDigits& dg,
                                        Pt& stash) {
  Pt acc = pt_identity();
  if constexpr (G >= 16) {
    Pt s = acc;
#pragma unroll 1
    for (int r = -1; r < kFoldRows; r++) {  // r = -1: s_0 only, half 0's sum dropped
#pragma unroll 1
      for (int k = r < 0 ? 4 : 0; k < 4; k++) acc = pt_dbl_warp<G, 2>(acc);
      const int q = r + 1 < kFoldRows ? r + 1 : r;
      Pt v;
      pt_add_pair<G>(acc, s, fold_entry(t[0], dg.d[0][q], dg.d[1][q]),
                     fold_entry(t[1], dg.d[2][q], dg.d[3][q]), v, s);
      if (r >= 0) acc = v;
    }
  } else {
#pragma unroll 1
    for (int r = 0; r < kFoldRows; r++) {
#pragma unroll 1
      for (int k = 0; k < 4; k++) acc = pt_dbl_warp<G>(acc);
      stash = acc;   // the group's threads store the same words
      __syncwarp();  // the stores before the loads
      const Pt s = pt_add_warp<G>(fold_entry(t[0], dg.d[0][r], dg.d[1][r]),
                                  fold_entry(t[1], dg.d[2][r], dg.d[3][r]));
      acc = pt_add_warp<G>(stash, s);
      __syncwarp();  // the loads before the next row's stores
    }
  }
  return acc;
}

// Lane w of the launch (of prover w / lanes) on a group of G threads.  The
// loop is uniform over the block; a group past the last lane computes lane
// count - 1 again and stores nothing (every thread takes part in the
// shuffles).  With Phi the O basis is phi(E) (GLV's k P = k1 P + k2 phi(P):
// shared_mul's fold): the group loads E_j once and makes phi(E_j) =
// (fe_mul(x, fe_beta()), y, z) in registers, endo_kernel's words, as
// complete_square_kernel's prologue does; ox..oz are not read.
template <int G, bool Phi>
__global__ void __launch_bounds__(32 * kFoldWarps)
    fold_many_kernel(const int64_t* __restrict__ ex, const int64_t* __restrict__ ey,
                     const int64_t* __restrict__ ez, const int64_t* __restrict__ ox,
                     const int64_t* __restrict__ oy, const int64_t* __restrict__ oz,
                     const __grid_constant__ FoldDigitsMany dig, int64_t* __restrict__ rx,
                     int64_t* __restrict__ ry, int64_t* __restrict__ rz, int64_t n,
                     int64_t lanes, int64_t first, int64_t count) {
  constexpr int per = kFoldManyLanes<G>;
  __shared__ FoldEntry tabs[per][2][9];
  __shared__ __align__(16) Pt stashes[per];  // fold_rows' acc at G = 8
  const int slot = threadIdx.x / G;
  FoldEntry(&tab)[2][9] = tabs[slot];
  for (int64_t w0 = blockIdx.x * (int64_t)per; w0 < count; w0 += (int64_t)gridDim.x * per) {
    const int64_t w = w0 + slot, wl = w < count ? w : count - 1, j = first + wl;
    if constexpr (Phi) {
      const Pt e = pt_load(ex, ey, ez, n, j);
      Pt phi = e;
      phi.x = fe_mul(e.x, fe_beta());
      if constexpr (G >= 16) {  // E on the group's first half, phi(E) on its second
        const int h = fold_half<G>();
        fold_table<G / 2>(tab[h], pt_select(h, phi, e));
      } else {
        fold_table<G>(tab[0], e);
        fold_table<G>(tab[1], phi);
      }
    } else if constexpr (G >= 16) {  // E on the group's first half, O on its second
      const int h = fold_half<G>();
      fold_table<G / 2>(tab[h], pt_load(h ? ox : ex, h ? oy : ey, h ? oz : ez, n, j));
    } else {
      fold_table<G>(tab[0], pt_load(ex, ey, ez, n, j));
      fold_table<G>(tab[1], pt_load(ox, oy, oz, n, j));
    }
    __syncwarp();  // the group's table stores before its reads
    const Pt acc = fold_rows<G>(tab, dig.p[wl / lanes], stashes[slot]);
    if (w < count) {
      int64_t* const dst[3] = {rx, ry, rz};
      const Fe v[3] = {acc.x, acc.y, acc.z};
      fe_store_group<G>(dst, v, n, j);
    }
    __syncwarp();  // every read of the tables before the next lane's stores
  }
}

// --- complete_square: replaces complete_square_kernel (bulletproofspp_tpu/
// ops/msm.py:283) with the endomorphism before it (ops/engine.py:41,
// :425-426), and jax.vmap(_csq_with_endo) (msm.py:301, :306): per lane
// gx = g1 + r g0 and hy = g1 - r g0, r g0 = b g0 + a phi(g0) through r's GLV
// halves, for B provers at once, each with its own digit streams.
//
// The JAX package compiles the whole square completion into one device
// program; the route before this kernel split it into an endo launch, a
// fold_many launch (or two table_flat and a fold at B = 1), a pneg launch
// and two padd launches over the same 16-256 lanes.  Each of endo, pneg
// and the narrow padd does a few nanoseconds of work (a product, a
// subtraction, an addition a lane) in a launch's fixed cost and the
// wrapper's host side, so no body of theirs could come near its bound;
// here they have no launch of their own.  The launch is fold_many's, with
// a prologue and an epilogue on the same group of threads:
//  * prologue: the group loads g0_j once; E's table is built from it and
//    O's from phi(g0_j) = (fe_mul(x, fe_beta()), y, z), endo_kernel's
//    words, kept in registers (at G >= 16 each half of the group builds one
//    table, at G = 8 the group builds both in turn: fold_many's build);
//  * the chain: fold_rows, fold_many's;
//  * epilogue: the group loads g1_j; g1 + acc and g1 + (acc.x, fe_neg(acc.y),
//    acc.z) through pt_add_warp with g1 first, as padd_narrow_kernel and
//    pneg_kernel compute them (at G >= 16 one sum a half, at G = 8 both in
//    turn), and each is stored by the threads that made it.
// So gx and hy equal the unfused route (endo, fold_many, padd(g1, rp) and
// padd(g1, pneg(rp))) word for word.  The group width is fold_many's
// (ops/kernels.py: fold_many_group); shared memory is its 2,400 B a lane,
// the epilogue takes none.
template <int G>
__global__ void __launch_bounds__(32 * kFoldWarps)
    complete_square_kernel(const int64_t* __restrict__ ax, const int64_t* __restrict__ ay,
                           const int64_t* __restrict__ az, const int64_t* __restrict__ bx,
                           const int64_t* __restrict__ by, const int64_t* __restrict__ bz,
                           const __grid_constant__ FoldDigitsMany dig,
                           int64_t* __restrict__ gx, int64_t* __restrict__ gy,
                           int64_t* __restrict__ gz, int64_t* __restrict__ hx,
                           int64_t* __restrict__ hy, int64_t* __restrict__ hz, int64_t n,
                           int64_t lanes, int64_t first, int64_t count) {
  constexpr int per = kFoldManyLanes<G>;
  __shared__ FoldEntry tabs[per][2][9];
  __shared__ __align__(16) Pt stashes[per];  // fold_rows' acc at G = 8
  const int slot = threadIdx.x / G;
  FoldEntry(&tab)[2][9] = tabs[slot];
  for (int64_t w0 = blockIdx.x * (int64_t)per; w0 < count; w0 += (int64_t)gridDim.x * per) {
    const int64_t w = w0 + slot, wl = w < count ? w : count - 1, j = first + wl;
    const Pt g0 = pt_load(ax, ay, az, n, j);
    Pt phi = g0;
    phi.x = fe_mul(g0.x, fe_beta());
    if constexpr (G >= 16) {  // E on the group's first half, O on its second
      const int h = fold_half<G>();
      fold_table<G / 2>(tab[h], pt_select(h, phi, g0));
    } else {
      fold_table<G>(tab[0], g0);
      fold_table<G>(tab[1], phi);
    }
    __syncwarp();  // the group's table stores before its reads
    const Pt acc = fold_rows<G>(tab, dig.p[wl / lanes], stashes[slot]);
    const Pt g1 = pt_load(bx, by, bz, n, j);
    Pt neg = acc;
    neg.y = fe_neg(acc.y);
    if constexpr (G >= 16) {  // g1 + acc on the first half, g1 - acc on the second
      const int h = fold_half<G>();
      const Pt s = pt_add_warp<G / 2>(g1, pt_select(h, neg, acc));
      if (w < count) {
        int64_t* const dst[3] = {h ? hx : gx, h ? hy : gy, h ? hz : gz};
        const Fe v[3] = {s.x, s.y, s.z};
        fe_store_group<G / 2>(dst, v, n, j);
      }
    } else {
      const Pt s = pt_add_warp<G>(g1, acc), d = pt_add_warp<G>(g1, neg);
      if (w < count) {
        int64_t* const dst[6] = {gx, gy, gz, hx, hy, hz};
        const Fe v[6] = {s.x, s.y, s.z, d.x, d.y, d.z};
        fe_store_group<G>(dst, v, n, j);
      }
    }
    __syncwarp();  // every read of the tables before the next lane's stores
  }
}

// complete_square's parameters: the digits, twelve pointers, four int64s
static_assert(sizeof(FoldDigitsMany) + 12 * sizeof(void*) + 4 * sizeof(int64_t) <= 4096,
              "complete_square's parameters must fit in 4 KB");

// fold_many_kernel<G, Phi> over `count` lanes; Phi where ox is null.
template <int G>
void fold_many_launch(const int64_t* ex, const int64_t* ey, const int64_t* ez, const int64_t* ox,
                      const int64_t* oy, const int64_t* oz, const FoldDigitsMany& dig,
                      int64_t* rx, int64_t* ry, int64_t* rz, int64_t n, int64_t lanes,
                      int64_t first, int64_t count, cudaStream_t s) {
  const int blocks = blocks_for(count, kFoldManyLanes<G>);
  if (ox) {
    fold_many_kernel<G, false><<<blocks, 32 * kFoldWarps, 0, s>>>(ex, ey, ez, ox, oy, oz, dig, rx,
                                                                  ry, rz, n, lanes, first, count);
  } else {
    fold_many_kernel<G, true><<<blocks, 32 * kFoldWarps, 0, s>>>(ex, ey, ez, ex, ey, ez, dig, rx,
                                                                 ry, rz, n, lanes, first, count);
  }
}

inline int fold_blocks(int64_t lanes) {
  const int64_t b = (lanes + kFoldWarps - 1) / kFoldWarps;
  return (int)(b > 65535 * 16 ? 65535 * 16 : b);
}

// The first level's operands: (16, w) planes x, y, z, or with FromTables
// flat tables x, y, z of w / rows lanes and (w / (rows L), rows, L) digits.
template <bool FromTables>
Operands<FromTables> operands(const int64_t* x, const int64_t* y, const int64_t* z,
                              const uint8_t* absd, const uint8_t* sgn, int64_t w, int64_t rows,
                              int64_t L) {
  return {x, y, z, absd, sgn, w, FromTables ? w / rows : 0, rows, L};
}

template <int F, bool FromTables>
int reduce_block_launch(const Operands<FromTables>& in, int64_t* ox, int64_t* oy, int64_t* oz,
                        int narrow, cudaStream_t s) {
  const int64_t n_out = in.w / F;
  if (n_out > 0 && narrow) {
    reduce_block_narrow_kernel<F, FromTables>
        <<<blocks_for(n_out, kReduceOuts<F>), kThreads, 0, s>>>(in, ox, oy, oz);
  } else if (n_out > 0) {
    reduce_block_kernel<F, FromTables><<<blocks_for(n_out), kThreads, 0, s>>>(in, ox, oy, oz);
  }
  return (int)cudaGetLastError();
}

template <bool FromTables>
int reduce_block_factor(const Operands<FromTables>& in, int64_t* ox, int64_t* oy, int64_t* oz,
                        int factor, int narrow, cudaStream_t s) {
  switch (factor) {
    case 2: return reduce_block_launch<2>(in, ox, oy, oz, narrow, s);
    case 4: return reduce_block_launch<4>(in, ox, oy, oz, narrow, s);
    case 8: return reduce_block_launch<8>(in, ox, oy, oz, narrow, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

void horner_launch(const int64_t* rx, const int64_t* ry, const int64_t* rz, int64_t* ox,
                   int64_t* oy, int64_t* oz, int64_t batch, int64_t rows, int canon,
                   cudaStream_t s) {
  const size_t smem = rows * sizeof(Pt);
  if (canon) {
    horner_warp_kernel<true><<<(unsigned)batch, 32, smem, s>>>(rx, ry, rz, ox, oy, oz, batch, rows);
  } else {
    horner_warp_kernel<false><<<(unsigned)batch, 32, smem, s>>>(rx, ry, rz, ox, oy, oz, batch, rows);
  }
}

}  // namespace

extern "C" {

// narrow: 1 runs the narrow design, 0 the wide one with `threads` a block.
int bppp_padd(const int64_t* x1, const int64_t* y1, const int64_t* z1, const int64_t* x2,
              const int64_t* y2, const int64_t* z2, int64_t* ox, int64_t* oy, int64_t* oz,
              int64_t n, int threads, int narrow, void* stream) {
  if (n > 0 && narrow) {
    padd_narrow_kernel<<<blocks_for(n, kNarrowLanes), kThreads, 0, (cudaStream_t)stream>>>(
        x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
  } else if (n > 0) {
    const int blocks = blocks_for(n, threads);
    cudaStream_t s = (cudaStream_t)stream;
    switch (threads) {
      case 128:
        padd_kernel<128><<<blocks, 128, 0, s>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
        break;
      case 256:
        padd_kernel<256><<<blocks, 256, 0, s>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
        break;
      case 512:
        padd_kernel<512><<<blocks, 512, 0, s>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
        break;
      case 1024:
        padd_kernel<1024><<<blocks, 1024, 0, s>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, n);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// canon: 1 stores fe_canon of X, Y and Z (ox, oy, oz: the planes of one
// stacked (3, 16, batch) tensor), 0 the projective sum.
int bppp_horner(const int64_t* rx, const int64_t* ry, const int64_t* rz, int64_t* ox,
                int64_t* oy, int64_t* oz, int64_t batch, int64_t rows, int canon, void* stream) {
  if (batch > 0) horner_launch(rx, ry, rz, ox, oy, oz, batch, rows, canon, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// narrow: 1 runs the narrow design, 0 the wide one.  absd null: x, y, z
// are (16, w) planes (rows and L unused); else the flat tables of w / rows
// lanes and absd, sgn the (w / (rows L), rows, L) uint8 digits, the w input
// lanes the points they select.
int bppp_reduce_block(const int64_t* x, const int64_t* y, const int64_t* z, const uint8_t* absd,
                      const uint8_t* sgn, int64_t* ox, int64_t* oy, int64_t* oz, int64_t rows,
                      int64_t L, int64_t w, int factor, int narrow, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!absd) {
    return reduce_block_factor(operands<false>(x, y, z, absd, sgn, w, rows, L), ox, oy, oz, factor,
                               narrow, s);
  }
  if (rows < 1 || L < 1 || w % (rows * L)) return (int)cudaErrorInvalidValue;
  return reduce_block_factor(operands<true>(x, y, z, absd, sgn, w, rows, L), ox, oy, oz, factor,
                             narrow, s);
}

// pairs: B rows (MSM, row) pairs of L lanes each, 2 <= L < 128 a power of two.
// tx, ty2, tz: the flat tables of batch L lanes and absd, sgn the (batch,
// rows, L) digits; with from_tables 0, tx, ty2, tz the (16, batch rows L)
// selected planes and absd, sgn unused.  levels: log2 L for the row sums.
int bppp_reduce_lanes(const int64_t* tx, const int64_t* ty2, const int64_t* tz,
                      const uint8_t* absd, const uint8_t* sgn, int64_t* ox, int64_t* oy,
                      int64_t* oz, int64_t batch, int64_t rows, int64_t L, int64_t levels,
                      int from_tables, void* stream) {
  if (L < 2 || L >= 128 || (L & (L - 1)) || levels < 1 || batch < 0 || rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t pairs = batch * rows, per = L >= 8 ? 1 : 8 / L;  // one block each `per` pairs
  if (pairs == 0) return (int)cudaGetLastError();
  if ((pairs + per - 1) / per > INT_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)((pairs + per - 1) / per);
  const cudaStream_t s = (cudaStream_t)stream;
  const int lv = (int)(levels < 64 ? levels : 64);
#define BPPP_REDUCE_LANES(N)                                                                   \
  reduce_lanes_kernel<N><<<blocks, N >= 8 ? 4 * N : 32, 0, s>>>(tx, ty2, tz, absd, sgn, ox, oy, \
                                                              oz, batch, rows, lv, from_tables)
  switch (L) {
    case 2: BPPP_REDUCE_LANES(2); break;
    case 4: BPPP_REDUCE_LANES(4); break;
    case 8: BPPP_REDUCE_LANES(8); break;
    case 16: BPPP_REDUCE_LANES(16); break;
    case 32: BPPP_REDUCE_LANES(32); break;
    default: BPPP_REDUCE_LANES(64); break;
  }
#undef BPPP_REDUCE_LANES
  return (int)cudaGetLastError();
}

// absd null: x, y, z the (16, batch, rows * 128) planes; else the flat
// tables of batch * 128 lanes and absd, sgn the (batch, rows, 128) uint8
// digits.  canon as bppp_horner's.
int bppp_tail_horner(const int64_t* x, const int64_t* y, const int64_t* z, const uint8_t* absd,
                     const uint8_t* sgn, int64_t* rx, int64_t* ry, int64_t* rz, int64_t* ox,
                     int64_t* oy, int64_t* oz, int64_t batch, int64_t rows, int canon,
                     void* stream) {
  if (batch > 0 && rows > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)(batch * rows);
    const int64_t w = batch * rows * 128;
    if (absd) {
      tail_rows_kernel<true><<<blocks, kTailThreads, 0, s>>>(
          operands<true>(x, y, z, absd, sgn, w, rows, 128), rx, ry, rz, batch * rows);
    } else {
      tail_rows_kernel<false><<<blocks, kTailThreads, 0, s>>>(
          operands<false>(x, y, z, absd, sgn, w, rows, 128), rx, ry, rz, batch * rows);
    }
    horner_launch(rx, ry, rz, ox, oy, oz, batch, rows, canon, s);
  }
  return (int)cudaGetLastError();
}

// narrow: 1 runs the narrow design, 0 the wide one.
int bppp_table_flat(const int64_t* px, const int64_t* py, const int64_t* pz, int64_t* tx,
                    int64_t* ty2, int64_t* tz, int64_t n, int narrow, void* stream) {
  if (n > 0 && narrow) {
    table_flat_narrow_kernel<<<blocks_for(n, kNarrowLanes), kThreads, 0, (cudaStream_t)stream>>>(
        px, py, pz, tx, ty2, tz, n);
  } else if (n > 0) {
    table_flat_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(px, py, pz, tx, ty2,
                                                                             tz, n);
  }
  return (int)cudaGetLastError();
}

int bppp_select_reduce(const int64_t* tx, const int64_t* ty2, const int64_t* tz,
                       const uint8_t* absd, const uint8_t* sgn, int64_t* ox, int64_t* oy,
                       int64_t* oz, int64_t batch, int64_t rows, int64_t L, int staged,
                       void* stream) {
  if (L % 1024) return (int)cudaErrorInvalidValue;
  const int64_t n_out = batch * rows * (L / 8), blocks = sr_blocks(batch, L);
  if (n_out <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (!staged) {
    select_reduce_rows_kernel<<<blocks_for(n_out), kThreads, 0, s>>>(tx, ty2, tz, absd, sgn, ox,
                                                                      oy, oz, batch, rows, L);
    return (int)cudaGetLastError();
  }
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(select_reduce_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSrSmem);
  if (e != cudaSuccess) return (int)e;
  select_reduce_kernel<<<(unsigned)blocks, kSrThreads<8>, kSrSmem, s>>>(tx, ty2, tz, absd, sgn, ox,
                                                                         oy, oz, batch, rows, L);
  return (int)cudaGetLastError();
}

int bppp_fold(const int64_t* ex, const int64_t* ey2, const int64_t* ez, const int64_t* ox,
              const int64_t* oy2, const int64_t* oz, const void* digits, int64_t* rx,
              int64_t* ry, int64_t* rz, int64_t n, void* stream) {
  if (n > 0) {
    fold_kernel<<<fold_blocks(n), 32 * kFoldWarps, 0, (cudaStream_t)stream>>>(
        ex, ey2, ez, ox, oy2, oz, *static_cast<const FoldDigits*>(digits), rx, ry, rz, n);
  }
  return (int)cudaGetLastError();
}

// digits: kFoldMaxProvers FoldDigits (those past the launch's provers
// unused); ex..oz the two bases' (16, n) strict points, or with ox null
// phi(E) for the O basis (fold_many_kernel<G, true>); the launch folds
// lanes [first, first + provers * lanes) on groups of `group` threads (8,
// 16 or 32).
int bppp_fold_many(const int64_t* ex, const int64_t* ey, const int64_t* ez, const int64_t* ox,
                   const int64_t* oy, const int64_t* oz, const void* digits, int64_t* rx,
                   int64_t* ry, int64_t* rz, int64_t n, int64_t lanes, int64_t first,
                   int64_t provers, int group, void* stream) {
  if (provers < 1 || provers > kFoldMaxProvers || lanes < 1 || first < 0 ||
      first + provers * lanes > n) {
    return (int)cudaErrorInvalidValue;
  }
  const FoldDigitsMany& dig = *static_cast<const FoldDigitsMany*>(digits);
  const int64_t count = provers * lanes;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 8:
      fold_many_launch<8>(ex, ey, ez, ox, oy, oz, dig, rx, ry, rz, n, lanes, first, count, s);
      break;
    case 16:
      fold_many_launch<16>(ex, ey, ez, ox, oy, oz, dig, rx, ry, rz, n, lanes, first, count, s);
      break;
    case 32:
      fold_many_launch<32>(ex, ey, ez, ox, oy, oz, dig, rx, ry, rz, n, lanes, first, count, s);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// digits: kFoldMaxProvers FoldDigits (as bppp_fold_many's); ax..az g0 and
// bx..bz g1, (16, n) strict points; the launch completes lanes [first,
// first + provers * lanes) into gx..gz (g1 + r g0) and hx..hz (g1 - r g0) on
// groups of `group` threads (8 or 16).
int bppp_complete_square(const int64_t* ax, const int64_t* ay, const int64_t* az,
                         const int64_t* bx, const int64_t* by, const int64_t* bz,
                         const void* digits, int64_t* gx, int64_t* gy, int64_t* gz, int64_t* hx,
                         int64_t* hy, int64_t* hz, int64_t n, int64_t lanes, int64_t first,
                         int64_t provers, int group, void* stream) {
  if (provers < 1 || provers > kFoldMaxProvers || lanes < 1 || first < 0 ||
      first + provers * lanes > n) {
    return (int)cudaErrorInvalidValue;
  }
  const FoldDigitsMany& dig = *static_cast<const FoldDigitsMany*>(digits);
  const int64_t count = provers * lanes;
  const cudaStream_t s = (cudaStream_t)stream;
#define BPPP_COMPLETE_SQUARE(G)                                                                \
  complete_square_kernel<G><<<blocks_for(count, kFoldManyLanes<G>), 32 * kFoldWarps, 0, s>>>(  \
      ax, ay, az, bx, by, bz, dig, gx, gy, gz, hx, hy, hz, n, lanes, first, count)
  switch (group) {
    case 8: BPPP_COMPLETE_SQUARE(8); break;
    case 16: BPPP_COMPLETE_SQUARE(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BPPP_COMPLETE_SQUARE
  return (int)cudaGetLastError();
}

}  // extern "C"
