// The staged row phase that select_reduce's staged design (kernels.cu:
// select_reduce_kernel) and select_reduce_fused (select_reduce_fused.cu)
// share, with the block geometry and shared-memory layout it reads.
//
// Output (16, batch * rows * L / 8) row-major partials: for MSM b, row r and
// lane block k of 1,024, output lane t < 128 sums the entries selected by
// the digits of lanes k*1024 + t + m*128, m < 8, in the halving order (m
// with m + 4, then m + 2, then m + 1).  A block owns 16 output columns t of
// one lane block, that is 128 lanes (t + m * 128), whose entries 1..8 lie in
// shared memory as packed 32-bit words laid out [entry][word][lane] (98,304
// B; entry 0 is the identity, and -Y is made with fe_neg at selection, as
// table_flat makes the table's -Y, so the words are the same): staged there
// from the flat tables by select_reduce_kernel, built there by
// select_reduce_fused_kernel.  Then sr_rows walks all rows: one thread per
// (row, column) reads its 8 lanes' entries from shared memory (a warp holds
// 16 distinct lanes of two rows: banks conflict at most 2-way, whatever the
// digits) and sums them in registers.  176 threads (11 rows at a time) and
// two blocks an SM: registers, not shared memory, bound the threads in
// flight.
#pragma once

#include <cstddef>

#include "curve.cuh"

namespace bppp {

constexpr int kSrCols = 16;                      // output columns t a block
constexpr int kSrLanes = 8 * kSrCols;            // their lanes t + m * 128
constexpr int kSrGroups = 128 / kSrCols;         // blocks a lane block
constexpr int kSrSlots = 11;                     // rows a block runs at a time
constexpr int kSrThreads = kSrSlots * kSrCols;   // 176
constexpr int kSrWords = 8 * 24 * kSrLanes;      // entries 1..8, 24 words each
constexpr size_t kSrSmem = kSrWords * sizeof(u32);  // 98,304 B

// The block's MSM b, lane block k and column group g (g fastest in the
// grid), and the lane within MSM b of its shared-memory lane l = m * 16 + c.
struct SrBlock {
  int64_t b, k, g;
  __device__ __forceinline__ int64_t lane(int l) const {
    return k * 1024 + g * kSrCols + l % kSrCols + (l / kSrCols) * 128;
  }
};

__device__ __forceinline__ SrBlock sr_block(int64_t L) {
  const int64_t nblk = L / 1024;
  return {(int64_t)blockIdx.x / (kSrGroups * nblk), ((int64_t)blockIdx.x / kSrGroups) % nblk,
          (int64_t)blockIdx.x % kSrGroups};
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

// All rows, 11 at a time; thread (slot, c).  The entries must be in tab and
// the block synchronized.  The (batch, rows, L) digits are uint8, read a
// byte at a time: a thread's eight lie 128 lanes apart, and the wrapper
// promises no alignment wider than a byte.
__device__ __forceinline__ void sr_rows(const u32* tab, const uint8_t* __restrict__ absd,
                                        const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                                        int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                        int64_t batch, int64_t rows, int64_t L, const SrBlock& blk) {
  const int64_t per_row = L / 8, n_out = batch * rows * per_row;
  const int c = threadIdx.x % kSrCols, slot = threadIdx.x / kSrCols;
  for (int64_t r = slot; r < rows; r += kSrSlots) {
    const int64_t br = blk.b * rows + r, di = br * L + blk.lane(c);
    u32 sel[8];
#pragma unroll
    for (int m = 0; m < 8; m++) sel[m] = (u32)absd[di + m * 128] | (u32)sgn[di + m * 128] << 4;
    auto load = [&](int m) { return sr_entry(tab, m * kSrCols + c, sel[m]); };
    pt_store(ox, oy, oz, n_out, br * per_row + blk.k * 128 + blk.g * kSrCols + c,
             halving_tree<8>(load, 0, 1));
  }
}

}  // namespace bppp
