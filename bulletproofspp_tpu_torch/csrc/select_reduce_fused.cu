// select_reduce_fused: replaces select_reduce_fused_pallas /
// _select_reduce_scratch_kernel (bulletproofspp_tpu/ops/pallas_field.py:615,
// :563), the MSM route for 2^21 lanes and more.
//
// Contract (ops/kernels.py): points (16, batch * L) strict int64 planes,
// digits absd/sgn (batch, rows, L) uint8; output (16, batch * rows * L / 8)
// row-major partials, equal limb for limb to
// select_reduce(table_flat(p), absd, sgn): for MSM b, row r and lane block k
// of 1,024, output lane t < 128 sums the entries selected by the digits of
// lanes k*1024 + t + m*128, m < 8, in the halving order (m with m + 4, then
// m + 2, then m + 1).  The lanes' multiple tables never reach global memory.
//
// What bounds it on the H100: the table, then the chain.  The TPU kernel
// keeps a 1,024-lane block's table (2.36 MB) in VMEM; a block here has at
// most 227 KB of shared memory.  So a block takes the 128 lanes of 16 output
// columns, the layout of select_reduce's staged design (select_reduce.cuh,
// its F = 8 instance), and builds what that design stages: 128 of its 176
// threads load one lane each and form 1P..8P with table_flat's chain (acc = pt_add(acc, base), 7
// dependent additions), written as packed words straight into the shared
// [entry][word][lane] table (neighbouring threads, neighbouring words).  One
// __syncthreads, then sr_rows: one thread per (row, column), 11 rows at a
// time, 7 additions in registers a row, no synchronization.  The chain a
// block waits on is 7 + ceil(rows / 11) x 7 additions (28 at 33 rows).
// Because the entries are table_flat's words and the row phase is the
// staged kernel's code, the partials equal the two-kernel route's raw.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "select_reduce.cuh"

using namespace bppp;

namespace {

// point p as entry e (1..8) of shared-memory lane l
__device__ __forceinline__ void sr_put(u32* tab, int e, int l, const Pt& p) {
  u32* s = tab + (e - 1) * 24 * kSrLanes + l;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    s[k * kSrLanes] = p.x.w[k];
    s[(8 + k) * kSrLanes] = p.y.w[k];
    s[(16 + k) * kSrLanes] = p.z.w[k];
  }
}

__global__ void __launch_bounds__(kSrThreads<8>, 2)
    select_reduce_fused_kernel(const int64_t* __restrict__ px, const int64_t* __restrict__ py,
                               const int64_t* __restrict__ pz, const uint8_t* __restrict__ absd,
                               const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                               int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t batch,
                               int64_t rows, int64_t L) {
  extern __shared__ u32 tab[];  // [entry 1..8][24 words][128 lanes]
  const int l = threadIdx.x;
  const SrBlock blk = sr_block<8>(L, 128);

  // build: entries 1P..8P of shared-memory lane l, in table_flat's order
  if (l < kSrLanes) {
    const int64_t j = blk.b * L + blk.lane(l % kSrCols<8>, l / kSrCols<8>);
    const Pt base = pt_load(px, py, pz, batch * L, j);
    Pt acc = base;
    sr_put(tab, 1, l, acc);
    for (int e = 2; e <= 8; e++) {
      acc = pt_add(acc, base);
      sr_put(tab, e, l, acc);
    }
  }
  __syncthreads();
  sr_rows<8, false>(tab, absd, sgn, ox, oy, oz, batch, rows, blk);
}

}  // namespace

extern "C" {

int bppp_select_reduce_fused(const int64_t* px, const int64_t* py, const int64_t* pz,
                             const uint8_t* absd, const uint8_t* sgn, int64_t* ox, int64_t* oy,
                             int64_t* oz, int64_t batch, int64_t rows, int64_t L,
                             void* stream) {
  if (L % 1024) return (int)cudaErrorInvalidValue;
  int64_t blocks = sr_blocks(batch, L);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks > 0 && rows > 0) {
    cudaError_t e = cudaFuncSetAttribute(select_reduce_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSrSmem);
    if (e != cudaSuccess) return (int)e;
    select_reduce_fused_kernel<<<(unsigned)blocks, kSrThreads<8>, kSrSmem,
                                 (cudaStream_t)stream>>>(px, py, pz, absd, sgn, ox, oy, oz, batch,
                                                         rows, L);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
