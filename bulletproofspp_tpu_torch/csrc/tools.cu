// The measurement tools' kernels of the PyTorch port, for Hopper (sm_90a):
// sr_variant and grid_copy replace the Pallas kernels of
// tools/r5_experiments.py (sr_variant :115, grid_copy :145); chain replaces
// make_chain(...).run of tools/phase_bench.py (:43).  They serve
// bulletproofspp_tpu_torch/tools/ and the bench, not the prover.
//
// Contract (ops/kernels.py): (16, N) int64 planes of 16-bit limbs, strict in
// and out; flat multiple tables as table_flat writes them (entry e, limb i,
// lane j at (16 e + i) * L + j).  Every entry launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().
//
// What bounds them on the H100, and what the design does about it:
//  * sr_variant: integer multiply-adds, as select_reduce (kernels.cu): F - 1
//    complete additions of ~1,840 32-bit multiplies each per output lane
//    against F selected entries of 384 B.  One thread per output lane.  The
//    halving order is a template recursion (curve.cuh: halving_tree), so
//    at most log2 F + 1 partial sums are live: F = 16 (blk 2,048, out 128)
//    keeps 5 points in registers instead of 16, and no narrowing crosses
//    threads.  The digit-dependent gathers, not the adds, set the pace on
//    the card (r5 H3: the same adds without the selection take under half
//    the time).  At blk 1,024 / out 128 it computes select_reduce's
//    function (kernels.cu) in the gather design with the rows outermost.
//  * grid_copy: bytes.  It does no arithmetic: 128 B read and 33 x 128 B
//    written per lane.  One block per (lane block, row), as the TPU grid,
//    so its time over the block count is the fixed cost of a block; inside
//    it, 16-byte accesses without index division and streaming stores.
//  * chain: by bounds.py's count the padd phase is bound by its multiplies
//    and the one-plane phases by their bytes (384 B a lane for 8 steps);
//    their carry chains, which that count leaves out, set the pace.  One
//    thread per lane, the phase a template argument, the state in
//    registers across the steps.

#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"

using namespace bppp;

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b > 65535 * 16 ? 65535 * 16 : b);
}

// --- sr_variant: replaces tools/r5_experiments.py: sr_variant (:115) ------
// Kernel bodies _sr_kernel (:91) and _sr_kernel_noselect (:73).  Tables of L
// lanes, digits (rows, L); output (16, rows * L / F) in (row, block, lane)
// order, F = blk / out_w: output lane t of block i, row r sums the entries
// selected by the digits of lanes i * blk + t + m * out_w, m < F (noselect:
// entry 1 with +Y for every lane, the digits unread).  At blk 1,024 and
// out_w 128 this is select_reduce's function.
template <int F>
__global__ void sr_variant_kernel(const int64_t* __restrict__ tx, const int64_t* __restrict__ ty2,
                                  const int64_t* __restrict__ tz, const uint8_t* __restrict__ absd,
                                  const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                                  int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t rows,
                                  int64_t L, int64_t out_w, int noselect) {
  const int64_t blk = out_w * F, per_row = L / F, n_out = rows * per_row;
  for (int64_t o = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; o < n_out;
       o += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = o / per_row, q = o % per_row;
    const int64_t lane0 = (q / out_w) * blk + (q % out_w);
    auto load = [&](int m) {
      const int64_t l = lane0 + m * out_w;
      if (noselect) return table_entry(tx, ty2, tz, L, l, 1, 0);
      return table_entry(tx, ty2, tz, L, l, absd[r * L + l], sgn[r * L + l]);
    };
    pt_store(ox, oy, oz, n_out, o, halving_tree<F>(load, 0, 1));
  }
}

// --- grid_copy: replaces tools/r5_experiments.py: grid_copy (:145) --------
// Kernel body _copy_kernel (:140): x (16, L) -> o (16, rows * L), o[:, r L +
// l] = (x[:, l] + 1) mod 2^32.  Block (i, r) writes lane block i of row r:
// thread t of 512 takes the lane pairs t, t + 512, ... of each limb in
// turn (no division), 16 B a load and a store; the output (rows x the
// input, 277 MB at L = 65,536) is larger than L2, so it is stored
// streaming (__stcs) and x, read once per row, stays cached.
__global__ void grid_copy_kernel(const longlong2* __restrict__ x, longlong2* __restrict__ o,
                                 int64_t L, int64_t rows, int64_t blk) {
  const int64_t L2 = L / 2, pairs = blk / 2;
  const longlong2* src = x + blockIdx.x * pairs;
  longlong2* dst = o + blockIdx.y * L2 + blockIdx.x * pairs;
  const int64_t out_stride = rows * L2;
#pragma unroll 4
  for (int limb = 0; limb < 16; limb++) {
    for (int64_t q = threadIdx.x; q < pairs; q += blockDim.x) {
      const longlong2 v = __ldg(src + limb * L2 + q);
      __stcs(dst + limb * out_stride + q,
             make_longlong2((v.x + 1) & 0xffffffffLL, (v.y + 1) & 0xffffffffLL));
    }
  }
}

// --- chain: replaces tools/phase_bench.py: make_chain(...).run (:43) -------
// Kernel body _chain_kernel (:32): x <- body(x, b), rep times, per lane.
// The phases of phase_bench.PHASES (:122-136), by value:
enum Phase {
  kPadd,       // complete addition, 3 state planes (_padd_body)
  kMulW16,     // the product, one fold pass, no final fold (mod 2^256)
  kMulF16,     // x b mod p (_mul_f16)
  kMulSmall,   // 3 x mod p (_mul_small_f16)
  kAdd,        // x + b mod p (_add_f16)
  kAddS17,     // x + b mod p (_tighten_s17 of the raw sum)
  kSub,        // x - b mod p (_sub_f16)
  kSubRaw2,    // x - 2 b mod p (_sub_f16 of the raw 2 b)
  kCarryFull,  // the canonical value of 2 x + b mod p
  kProdForm,   // the 8 x 8-word schoolbook, its low 256 bits
};

// The product reduced by one pass T = L + 977 H + 2^32 H, with the carry out
// of 2^256 dropped (fe_reduce512 without its fe_fold).
__device__ __forceinline__ Fe fe_mul_unfolded(const Fe& a, const Fe& b) {
  u32 t[16];
  fe_mul_wide(a, b, t);
  Fe r;
  u64 acc = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    acc += (u64)t[k] + (u64)t[8 + k] * 977u;
    if (k > 0) acc += t[7 + k];
    r.w[k] = (u32)acc;
    acc >>= 32;
  }
  return r;
}

__device__ __forceinline__ Fe fe_mul_low(const Fe& a, const Fe& b) {
  u32 t[16];
  fe_mul_wide(a, b, t);
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = t[k];
  return r;
}

template <int P>
__device__ __forceinline__ Fe chain_step(const Fe& x, const Fe& b) {
  if constexpr (P == kMulW16) return fe_mul_unfolded(x, b);
  if constexpr (P == kMulF16) return fe_mul(x, b);
  if constexpr (P == kMulSmall) return fe_mul_small(x, 3);
  if constexpr (P == kAdd || P == kAddS17) return fe_add(x, b);
  if constexpr (P == kSub) return fe_sub(x, b);
  if constexpr (P == kSubRaw2) return fe_sub(x, fe_add(b, b));
  if constexpr (P == kCarryFull) return fe_canon(fe_add(fe_add(x, x), b));
  if constexpr (P == kProdForm) return fe_mul_low(x, b);
  return x;
}

template <int P>
__global__ void chain_kernel(const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                             const int64_t* __restrict__ a2, const int64_t* __restrict__ b0,
                             const int64_t* __restrict__ b1, const int64_t* __restrict__ b2,
                             int64_t* __restrict__ out, int64_t n, int rep) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    if constexpr (P == kPadd) {
      Pt x = pt_load(a0, a1, a2, n, j);
      const Pt b = pt_load(b0, b1, b2, n, j);
      for (int i = 0; i < rep; i++) x = pt_add(x, b);
      fe_store(out, n, j, x.x);
    } else {
      Fe x = fe_load(a0, n, j);
      const Fe b = fe_load(b0, n, j);
      for (int i = 0; i < rep; i++) x = chain_step<P>(x, b);
      fe_store(out, n, j, x);
    }
  }
}

template <int P>
void launch_chain(const int64_t* a0, const int64_t* a1, const int64_t* a2, const int64_t* b0,
                  const int64_t* b1, const int64_t* b2, int64_t* out, int64_t n, int rep,
                  cudaStream_t s) {
  chain_kernel<P><<<blocks_for(n), kThreads, 0, s>>>(a0, a1, a2, b0, b1, b2, out, n, rep);
}

}  // namespace

extern "C" {

int bppp_sr_variant(const int64_t* tx, const int64_t* ty2, const int64_t* tz, const uint8_t* absd,
                    const uint8_t* sgn, int64_t* ox, int64_t* oy, int64_t* oz, int64_t rows,
                    int64_t L, int64_t blk, int64_t out_w, int noselect, void* stream) {
  if (out_w <= 0 || blk % out_w || L % blk) return (int)cudaErrorInvalidValue;
  const int64_t n_out = rows * (L / (blk / out_w));
  if (n_out <= 0) return (int)cudaGetLastError();
  const int blocks = blocks_for(n_out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (blk / out_w) {
    case 2:
      sr_variant_kernel<2><<<blocks, kThreads, 0, s>>>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows, L,
                                                       out_w, noselect);
      break;
    case 4:
      sr_variant_kernel<4><<<blocks, kThreads, 0, s>>>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows, L,
                                                       out_w, noselect);
      break;
    case 8:
      sr_variant_kernel<8><<<blocks, kThreads, 0, s>>>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows, L,
                                                       out_w, noselect);
      break;
    case 16:
      sr_variant_kernel<16><<<blocks, kThreads, 0, s>>>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows,
                                                        L, out_w, noselect);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bppp_grid_copy(const int64_t* x, int64_t* o, int64_t L, int64_t rows, int64_t blk,
                   void* stream) {
  if (blk <= 0 || blk % 2 || L % blk || rows > 65535 || (uintptr_t)x % 16 || (uintptr_t)o % 16)
    return (int)cudaErrorInvalidValue;
  if (L > 0 && rows > 0) {
    dim3 grid((unsigned)(L / blk), (unsigned)rows);
    grid_copy_kernel<<<grid, 512, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const longlong2*>(x), reinterpret_cast<longlong2*>(o), L, rows, blk);
  }
  return (int)cudaGetLastError();
}

int bppp_chain(int phase, const int64_t* a0, const int64_t* a1, const int64_t* a2,
               const int64_t* b0, const int64_t* b1, const int64_t* b2, int64_t* out, int64_t n,
               int rep, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (phase) {
    case kPadd: launch_chain<kPadd>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kMulW16: launch_chain<kMulW16>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kMulF16: launch_chain<kMulF16>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kMulSmall: launch_chain<kMulSmall>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kAdd: launch_chain<kAdd>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kAddS17: launch_chain<kAddS17>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kSub: launch_chain<kSub>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kSubRaw2: launch_chain<kSubRaw2>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kCarryFull: launch_chain<kCarryFull>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    case kProdForm: launch_chain<kProdForm>(a0, a1, a2, b0, b1, b2, out, n, rep, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
