// select_reduce_fused: replaces select_reduce_fused_pallas /
// _select_reduce_scratch_kernel (bulletproofspp_tpu/ops/pallas_field.py:615,
// :563), the MSM route for 2^21 lanes and more.
//
// Contract (ops/kernels.py): points (16, batch * L) strict int64 planes,
// digits absd/sgn (batch, rows, L) int64; output (16, batch * rows * L / 8)
// row-major partials, equal after normalization to
// select_reduce(table_flat(p), absd, sgn): for MSM b, row r and lane block k
// of 1,024, output lane t < 128 sums the entries selected by the digits of
// lanes k*1024 + t + m*128, m < 8, in the halving order (m with m + 4, then
// m + 2, then m + 1).  The lanes' multiple tables never reach global memory.
//
// What bounds it on the H100: the table.  The TPU kernel keeps a 1,024-lane
// block's table (2.36 MB) in VMEM; a block here has at most 227 KB of shared
// memory.  So one block takes 128 lanes, the 8 lanes m of 16 output columns
// t (one thread per lane, thread = m * 16 + c), builds their entries 1P..8P
// once into shared memory (8 x 96 B per lane, 98,304 B; entry 0 is the
// identity and -Y is made at selection), then walks the rows: each thread
// picks its own lane's entry by the row's digit, and the 8 lanes of a column
// are summed through a 64-point exchange buffer in three halving steps.
// Shared memory is laid out [entry][coordinate][word][lane], so the 32
// threads of a warp read 32 banks whatever their digits.  At 104,448 B per
// block two blocks share an SM, so a block's 7-add build and its 33 rows of
// select + 4/2/1 adds are latency-bound at low occupancy; speed is later
// work (more lanes per thread, fewer syncs).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "curve.cuh"

using namespace bppp;

namespace {

constexpr int kCols = 16;               // output columns t per block
constexpr int kLanes = 8 * kCols;       // 128 lanes, one thread each
constexpr int kGroups = 128 / kCols;    // blocks per 1,024-lane block
constexpr int kPtWords = 24;            // X, Y, Z as 8 words each
constexpr int kTableWords = 8 * kPtWords * kLanes;  // entries 1..8
constexpr int kSwapLanes = kLanes / 2;              // m = 4..7 write first
constexpr size_t kSmem = (size_t)(kTableWords + kPtWords * kSwapLanes) * sizeof(u32);

// point <-> shared memory, words of lane j at stride ``stride``
__device__ __forceinline__ void pt_put(u32* s, int stride, int j, const Pt& p) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    s[k * stride + j] = p.x.w[k];
    s[(8 + k) * stride + j] = p.y.w[k];
    s[(16 + k) * stride + j] = p.z.w[k];
  }
}

__device__ __forceinline__ Pt pt_get(const u32* s, int stride, int j) {
  Pt p;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p.x.w[k] = s[k * stride + j];
    p.y.w[k] = s[(8 + k) * stride + j];
    p.z.w[k] = s[(16 + k) * stride + j];
  }
  return p;
}

__global__ void __launch_bounds__(kLanes)
    select_reduce_fused_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                               const int64_t* __restrict__ pz, const int64_t* __restrict__ absd,
                               const int64_t* __restrict__ sgn, int64_t* __restrict__ ox,
                               int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t batch,
                               int64_t rows, int64_t L) {
  extern __shared__ u32 smem[];
  u32* table = smem;                // [entry 1..8][24 words][128 lanes]
  u32* swap = smem + kTableWords;   // [24 words][64 lanes]
  const int tid = threadIdx.x;
  const int c = tid % kCols, m = tid / kCols;
  const int64_t nblk = L / 1024;
  const int64_t blk = blockIdx.x;  // (b, k, g), g fastest
  const int64_t g = blk % kGroups, k = (blk / kGroups) % nblk, b = blk / (kGroups * nblk);
  const int64_t t = g * kCols + c;             // output column in the lane block
  const int64_t lane = k * 1024 + t + m * 128;  // lane within MSM b
  const int64_t n = batch * L, per_row = L / 8, n_out = batch * rows * per_row;

  // build: entries 1P..8P of this thread's lane (7 complete additions)
  const Pt base = pt_load(px, py, pz, n, b * L + lane);
  Pt acc = base;
  pt_put(table, kLanes, tid, acc);
  for (int e = 2; e <= 8; e++) {
    acc = pt_add(acc, base);
    pt_put(table + (e - 1) * kPtWords * kLanes, kLanes, tid, acc);
  }

  for (int64_t r = 0; r < rows; r++) {
    const int64_t di = (b * rows + r) * L + lane;
    const int64_t d = absd[di];
    Pt v = d == 0 ? pt_identity() : pt_get(table + (d - 1) * kPtWords * kLanes, kLanes, tid);
    if (sgn[di]) v.y = fe_neg(v.y);
    for (int h = 4; h >= 1; h /= 2) {
      if (m >= h && m < 2 * h) pt_put(swap, kSwapLanes, tid - h * kCols, v);
      __syncthreads();
      if (m < h) v = pt_add(v, pt_get(swap, kSwapLanes, tid));
      __syncthreads();
    }
    if (m == 0) pt_store(ox, oy, oz, n_out, (b * rows + r) * per_row + k * 128 + t, v);
  }
}

}  // namespace

extern "C" {

int bppp_select_reduce_fused(const int64_t* px, const int64_t* py, const int64_t* pz,
                             const int64_t* absd, const int64_t* sgn, int64_t* ox, int64_t* oy,
                             int64_t* oz, int64_t batch, int64_t rows, int64_t L,
                             void* stream) {
  if (L % 1024) return (int)cudaErrorInvalidValue;
  int64_t blocks = batch * (L / 1024) * kGroups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks > 0 && rows > 0) {
    cudaError_t e = cudaFuncSetAttribute(select_reduce_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    select_reduce_fused_kernel<<<(unsigned)blocks, kLanes, kSmem, (cudaStream_t)stream>>>(
        px, py, pz, absd, sgn, ox, oy, oz, batch, rows, L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
