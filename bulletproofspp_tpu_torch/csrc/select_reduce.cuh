// The staged row phase, with the block geometry and shared-memory layout it
// reads: one body for select_reduce's staged design (kernels.cu:
// select_reduce_kernel), select_reduce_fused (select_reduce_fused.cu) and
// the measurement tool's sr_variant (tools.cu: sr_variant_kernel).
//
// Function, for F = blk / out_w in {2, 4, 8, 16}: output (16, batch * rows
// * L / F) row-major partials: for MSM b, row r and lane block k of blk
// lanes, output lane t < out_w (column q = k * out_w + t of the row) sums
// the entries selected by the digits of lanes k*blk + t + m*out_w, m < F,
// in the halving order (m with m + F/2, then m + F/4, ...).  select_reduce
// and select_reduce_fused are the instance F = 8, blk 1,024, out 128, with
// that geometry constant at compile time.
//
// A block owns C = 128 / F consecutive columns of one MSM, that is 128
// lanes, whose entries 1..8 lie in shared memory as packed 32-bit words
// laid out [entry][word][lane l = m * C + c] (98,304 B; entry 0 is the
// identity, and -Y is made with fe_neg at selection, as table_flat makes
// the table's -Y, so the words are the same): staged there from the flat
// tables by sr_stage (select_reduce_kernel, sr_variant_kernel), built there
// by select_reduce_fused_kernel.  Then sr_rows walks all rows: one thread
// per (row, column) reads its F lanes' entries from shared memory and sums
// them in registers with halving_tree<F>, kSrSlots<F> rows at a time (176
// or 192 threads: two blocks an SM, bound by registers, not by shared
// memory).  At F = 8 a warp holds 16 distinct lanes of two rows (banks
// conflict at most 2-way, whatever the digits); at F = 2 and 4 one row's 32
// lanes, at 16 four rows' 8.  Where blk is a multiple of 128 (every F = 8
// launch, and the tool's H3 / H4 cases) a block's columns lie in one lane
// block, and a lane is its first lane plus c + m * out_w; otherwise each
// lane is found by division and read a word at a time.
#pragma once

#include <cstddef>

#include "curve.cuh"

namespace bppp {

constexpr int kSrLanes = 128;                       // lanes a block stages
template <int F>
constexpr int kSrCols = kSrLanes / F;               // output columns a block
// rows a block runs at a time.  Two blocks an SM (shared memory allows two)
// of 176 or 192 threads (six warps) leave ptxas 168 registers a thread,
// which every F fits without spilling; 11 rows at F = 8 walk the 33 digit
// rows in three passes (10 rows, 160 threads and 200 registers, took four
// and ran slower on the H100), and the other F keep about as many threads.
template <int F>
constexpr int kSrSlots = F == 2 ? 3 : F == 4 ? 6 : F == 8 ? 11 : 22;
template <int F>
constexpr int kSrThreads = kSrSlots<F> * kSrCols<F>;  // 192, 192, 176, 176
constexpr int kSrWords = 8 * 24 * kSrLanes;          // entries 1..8, 24 words each
constexpr size_t kSrSmem = kSrWords * sizeof(u32);   // 98,304 B

// The block's MSM b and first column q0 (blocks in (MSM, column group)
// order), its geometry, and the lane within MSM b of its column q0 + c, m-th
// (c < C, m < F).
struct SrBlock {
  int64_t b, L;
  int64_t q0, ncols, out_w, blk;
  int64_t base;  // lane(0, 0) where a block's columns lie in one lane block
  bool aligned;  // blk % 128 == 0
  __device__ __forceinline__ int64_t lane(int c, int m) const {
    if (aligned) return base + c + m * out_w;
    const int64_t q = q0 + c;
    return (q / out_w) * blk + q % out_w + m * out_w;
  }
};

template <int F>
__device__ __forceinline__ SrBlock sr_block(int64_t L, int64_t out_w) {
  const int64_t ncols = L / F, per_msm = (ncols + kSrCols<F> - 1) / kSrCols<F>;
  SrBlock s;
  s.b = (int64_t)blockIdx.x / per_msm;
  s.L = L;
  s.q0 = ((int64_t)blockIdx.x % per_msm) * kSrCols<F>;
  s.ncols = ncols;
  s.out_w = out_w;
  s.blk = out_w * F;
  s.aligned = s.blk % kSrLanes == 0;
  s.base = s.aligned ? (s.q0 / out_w) * s.blk + s.q0 % out_w : 0;
  return s;
}

// Blocks of a launch: batch MSMs of ceil(L / 128) blocks.
inline int64_t sr_blocks(int64_t batch, int64_t L) {
  return batch * ((L + kSrLanes - 1) / kSrLanes);
}

// Entry |d| of shared-memory lane l with sign s (sel = |d| | s << 4).
__device__ __forceinline__ Pt sr_entry(const u32* tab, int l, u32 sel) {
  const int d = sel & 15;
  const u32* e = tab + (d ? d - 1 : 0) * 24 * kSrLanes + l;
  Pt p = pt_identity();
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p.x.w[k] = d ? e[k * kSrLanes] : p.x.w[k];
    p.y.w[k] = d ? e[(8 + k) * kSrLanes] : p.y.w[k];
    p.z.w[k] = d ? e[(16 + k) * kSrLanes] : p.z.w[k];
  }
  if (sel >> 4) p.y = fe_neg(p.y);
  return p;
}

// Stage the block's lanes' entries 1..8 from flat tables of n lanes.  With
// aligned geometry thread i takes the staged lanes 2 l', 2 l' + 1 (columns
// c, c + 1: neighbouring lanes) of one word, one 16-byte load of each of
// the word's two limb planes; otherwise one lane of one word, the columns
// past the row's last skipped.
template <int F>
__device__ __forceinline__ void sr_stage(u32* tab, const int64_t* __restrict__ tx,
                                         const int64_t* __restrict__ ty2,
                                         const int64_t* __restrict__ tz, int64_t n,
                                         const SrBlock& blk) {
  constexpr int C = kSrCols<F>;
  const int64_t* planes[3] = {tx, ty2, tz};
  if (blk.aligned) {
#pragma unroll 4
    for (int i = threadIdx.x; i < kSrWords / 2; i += kSrThreads<F>) {
      const int lp = i % (kSrLanes / 2), ew = i / (kSrLanes / 2);  // ew = (e - 1) * 24 + word
      const int e = ew / 24 + 1, w = ew % 24;
      const int l = 2 * lp;
      const int64_t col = blk.b * blk.L + blk.lane(l % C, l / C);
      const longlong2* p = reinterpret_cast<const longlong2*>(planes[w / 8]) +
                           ((16 * e + 2 * (w % 8)) * n + col) / 2;
      const longlong2 lo = __ldg(p), hi = __ldg(p + n / 2);
      reinterpret_cast<uint2*>(tab)[(ew * kSrLanes + l) / 2] =
          make_uint2(((u32)lo.x & 0xffffu) | ((u32)hi.x << 16),
                     ((u32)lo.y & 0xffffu) | ((u32)hi.y << 16));
    }
  } else {
    for (int i = threadIdx.x; i < kSrWords; i += kSrThreads<F>) {
      const int l = i % kSrLanes, ew = i / kSrLanes;
      const int e = ew / 24 + 1, w = ew % 24;
      if (blk.q0 + l % C >= blk.ncols) continue;
      const int64_t* p = planes[w / 8] + (16 * e + 2 * (w % 8)) * n + blk.b * blk.L +
                         blk.lane(l % C, l / C);
      tab[ew * kSrLanes + l] = ((u32)__ldg(p) & 0xffffu) | ((u32)__ldg(p + n) << 16);
    }
  }
}

// All rows, kSrSlots<F> at a time; thread (slot, c).  The entries must be
// in tab and the block synchronized.  The (batch, rows, L) digits are
// uint8, read a byte at a time as each entry is taken (a thread's F lie
// out_w lanes apart, and the wrappers promise no alignment wider than a
// byte): held in registers across the tree's pt_add calls instead, they
// cost the kernel a larger stack frame.  NoSelect (the tool's H3
// yardstick) takes entry 1 with +Y for every lane and reads no digits.
template <int F, bool NoSelect>
__device__ __forceinline__ void sr_rows(const u32* tab, const uint8_t* __restrict__ absd,
                                        const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                                        int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                        int64_t batch, int64_t rows, const SrBlock& blk) {
  constexpr int C = kSrCols<F>;
  const int c = threadIdx.x % C, slot = threadIdx.x / C;
  if (blk.q0 + c >= blk.ncols) return;
  const int64_t n_out = batch * rows * blk.ncols, lane0 = blk.lane(c, 0);
  for (int64_t r = slot; r < rows; r += kSrSlots<F>) {
    const int64_t br = blk.b * rows + r, di = br * blk.L + lane0;
    auto load = [&](int m) {
      const int64_t d = di + m * blk.out_w;
      return sr_entry(tab, m * C + c, NoSelect ? 1u : (u32)absd[d] | (u32)sgn[d] << 4);
    };
    pt_store(ox, oy, oz, n_out, br * blk.ncols + blk.q0 + c, halving_tree<F>(load, 0, 1));
  }
}

// The staged design whole: stage from the flat tables (batch * L lanes),
// synchronize, walk the rows.
template <int F, bool NoSelect>
__device__ __forceinline__ void sr_staged(u32* tab, const int64_t* __restrict__ tx,
                                          const int64_t* __restrict__ ty2,
                                          const int64_t* __restrict__ tz,
                                          const uint8_t* __restrict__ absd,
                                          const uint8_t* __restrict__ sgn,
                                          int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                                          int64_t* __restrict__ oz, int64_t batch, int64_t rows,
                                          int64_t L, int64_t out_w) {
  const SrBlock blk = sr_block<F>(L, out_w);
  sr_stage<F>(tab, tx, ty2, tz, batch * L, blk);
  __syncthreads();
  sr_rows<F, NoSelect>(tab, absd, sgn, ox, oy, oz, batch, rows, blk);
}

}  // namespace bppp
