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
//    against F selected entries of 384 B, once the selection is cheap.  It
//    runs select_reduce's staged row phase (select_reduce.cuh), the design
//    the MSM runs, at the tool's F and geometry: a block stages 128 lanes'
//    entries 1..8 in shared memory (C = 128 / F columns of a lane block,
//    blk / 128 column groups a lane block), then one thread per (row,
//    column) sums its F entries with halving_tree<F> (at most log2 F + 1
//    partial sums live).  So r5's H3 (the selection's cost: noselect stages
//    the same words and reads entry 1) and H4 (wider or narrower blocks)
//    measure the MSM's own design.  At blk 1,024 / out 128 it is
//    select_reduce_kernel's launch.
//  * grid_copy: bytes.  It does no arithmetic: 128 B read and 33 x 128 B
//    written per lane.  One block per (lane block, row), as the TPU grid,
//    so its time over the block count is the fixed cost of a block; inside
//    it, 16-byte accesses without index division and streaming stores.
//  * chain: by bounds.py's count the padd phase is bound by its multiplies
//    and the one-plane phases by their bytes (384 B a lane for 8 steps);
//    their carry chains, which that count leaves out, set the pace.  Its
//    steps are field.cuh's functions (32-bit PTX carry chains), so it
//    times the arithmetic every kernel runs: one thread per lane, the phase
//    a template argument, the state in registers across the steps; at
//    65,536 lanes its throughput, at one warp (32 lanes) the latency of a
//    dependent step (tools/phase_bench.py).  Its round phases run the point
//    chains' additions and doublings on a group of G threads a lane
//    (curve_warp.cuh, a product on S = 1 or 2 threads), at the (G, S) of
//    each chain: fold_rows' 16 and 2 (and the former 16 and 1), horner's 32
//    and 2 (and the former 32 and 1), tail_rows' 8 and 1, and fold_rows'
//    paired addition (two halves of 8, S = 1, and their hand-over); they
//    can clock each part of a round.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "curve_warp.cuh"
#include "select_reduce.cuh"

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
// entry 1 with +Y for every lane, the digits unread).  The staged row phase
// of select_reduce (select_reduce.cuh: sr_staged) at this F and geometry,
// one MSM: at blk 1,024 / out 128 it is select_reduce_kernel's launch.
template <int F, bool NoSelect>
__global__ void __launch_bounds__(kSrThreads<F>, 2)
    sr_variant_kernel(const int64_t* __restrict__ tx, const int64_t* __restrict__ ty2,
                      const int64_t* __restrict__ tz, const uint8_t* __restrict__ absd,
                      const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                      int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t rows, int64_t L,
                      int64_t out_w) {
  extern __shared__ u32 tab[];  // [entry 1..8][24 words][128 lanes]
  sr_staged<F, NoSelect>(tab, tx, ty2, tz, absd, sgn, ox, oy, oz, 1, rows, L, out_w);
}

template <int F>
int launch_sr_variant(const int64_t* tx, const int64_t* ty2, const int64_t* tz,
                      const uint8_t* absd, const uint8_t* sgn, int64_t* ox, int64_t* oy,
                      int64_t* oz, int64_t rows, int64_t L, int64_t out_w, int noselect,
                      cudaStream_t s) {
  const int64_t blocks = sr_blocks(1, L);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto* kernel = noselect ? sr_variant_kernel<F, true> : sr_variant_kernel<F, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSrSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, kSrThreads<F>, kSrSmem, s>>>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows,
                                                          L, out_w);
  return (int)cudaGetLastError();
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
  // a complete addition or doubling on a group of G threads a lane, 3
  // state planes, in curve_warp.cuh's rounds, each product on S threads:
  // G = 16 (kAddWarp, kDblWarp: S = 1; kAddSplit, kDblSplit: S = 2,
  // fold_rows' doublings), G = 32 (horner's: S = 1, 2), G = 8, S = 1 (the
  // narrow kernels' and tail_rows' additions) and kAddPair: fold_rows'
  // paired addition, a group of 16 whose halves of 8 each add (S = 1),
  // then trade their sums by shuffles (curve_warp.cuh: pt_add_pair)
  kAddWarp,
  kDblWarp,
  kAddSplit,
  kDblSplit,
  kAdd32S1,
  kDbl32S1,
  kAdd32S2,
  kDbl32S2,
  kAdd8S1,
  kAddPair,
};

// The product reduced by one pass T = L + 977 H + 2^32 H, with the carry out
// of 2^256 dropped (fe_reduce512 without its fe_fold).
__device__ __forceinline__ Fe fe_mul_unfolded(const Fe& a, const Fe& b) {
  u32 t[16], chi;
  fe_mul_wide(a, b, t);
  Fe r;
  fe_reduce_pass(t, r, chi);
  return r;
}

// The low 256 bits of the product: its 36 word products under 2^256.
__device__ __forceinline__ Fe fe_mul_low(const Fe& a, const Fe& b) {
  Fe r;
  fe_mul_words<8>(a, b, r.w);
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

// --- the rounds' phases: x <- pt_add(x, b) or pt_dbl(x) on a group of G
// threads a lane, its rounds' products on S threads.  At one warp (32 / G
// lanes) the latency of a dependent addition or doubling, two product
// rounds.  With clocks, group thread 0 of each lane also sums the SM cycles
// (clock64) each part of its rounds took, RoundPart by RoundPart, into
// clocks[part * n + lane]: a part ends when its results are ready
// (PartClock folds their words into a sink before reading the clock).
struct PartClock {
  long long last;
  long long cyc[kRoundParts];
  u32 sink;

  __device__ __forceinline__ void start() {
#pragma unroll
    for (int k = 0; k < kRoundParts; k++) cyc[k] = 0;
    sink = 0;
    last = clock64();
  }

  template <class T>
  __device__ __forceinline__ void wait(const T& v) {
    const u32* w = reinterpret_cast<const u32*>(&v);
    u32 x = 0;
#pragma unroll
    for (int k = 0; k < (int)(sizeof(T) / 4); k++) x ^= w[k];
    asm volatile("xor.b32 %0, %0, %1;" : "+r"(sink) : "r"(x));
  }

  template <class... T>
  __device__ __forceinline__ void mark(int part, const T&... v) {
    (wait(v), ...);
    const long long t = clock64();
    cyc[part] += t - last;
    last = t;
  }
};

// With Pair: the paired addition, half 0 x + b beside half 1 b + x; the
// step keeps half 0's sum (the addition's words).
template <bool Add, int G, int S, bool Pair, class Parts>
__device__ __forceinline__ Pt round_step(const Pt& x, const Pt& b, Parts& parts) {
  if constexpr (Pair) {
    Pt r0, r1;
    pt_add_pair<G>(x, b, b, x, r0, r1, parts);
    return r0;
  } else if constexpr (Add) {
    return pt_add_warp<G, S>(x, b, parts);
  } else {
    return pt_dbl_warp<G, S>(x, parts);
  }
}

// One launch covers every lane; a group past the last lane runs lane n - 1
// again and stores nothing (every thread takes part in the shuffles).
template <bool Add, int G, int S, bool Pair>
__global__ void round_kernel(const int64_t* __restrict__ a0, const int64_t* __restrict__ a1,
                             const int64_t* __restrict__ a2, const int64_t* __restrict__ b0,
                             const int64_t* __restrict__ b1, const int64_t* __restrict__ b2,
                             int64_t* __restrict__ out, int64_t n, int rep,
                             int64_t* __restrict__ clocks) {
  const int64_t w = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / G;
  const int64_t j = w < n ? w : n - 1;
  const bool lead = w < n && (threadIdx.x & (G - 1)) == 0;
  Pt x = pt_load(a0, a1, a2, n, j);
  const Pt b = pt_load(b0, b1, b2, n, j);
  if (clocks) {
    PartClock pc;
    pc.start();
    for (int i = 0; i < rep; i++) x = round_step<Add, G, S, Pair>(x, b, pc);
    if (lead) {
#pragma unroll
      for (int k = 0; k < kRoundParts; k++) clocks[k * n + w] = pc.cyc[k] + (pc.sink == 1u);
    }
  } else {
    NoParts none;
    for (int i = 0; i < rep; i++) x = round_step<Add, G, S, Pair>(x, b, none);
  }
  if (lead) fe_store(out, n, w, x.x);
}

template <bool Add, int G, int S, bool Pair>
void launch_round(const int64_t* a0, const int64_t* a1, const int64_t* a2, const int64_t* b0,
                  const int64_t* b1, const int64_t* b2, int64_t* out, int64_t n, int rep,
                  int64_t* clocks, cudaStream_t s) {
  round_kernel<Add, G, S, Pair><<<blocks_for(n * G), kThreads, 0, s>>>(a0, a1, a2, b0, b1, b2,
                                                                       out, n, rep, clocks);
}

}  // namespace

extern "C" {

int bppp_sr_variant(const int64_t* tx, const int64_t* ty2, const int64_t* tz, const uint8_t* absd,
                    const uint8_t* sgn, int64_t* ox, int64_t* oy, int64_t* oz, int64_t rows,
                    int64_t L, int64_t blk, int64_t out_w, int noselect, void* stream) {
  if (out_w <= 0 || blk % out_w || L % blk) return (int)cudaErrorInvalidValue;
  const int64_t n_out = rows * (L / (blk / out_w));
  if (n_out <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (blk / out_w) {
    case 2:
      return launch_sr_variant<2>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows, L, out_w, noselect, s);
    case 4:
      return launch_sr_variant<4>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows, L, out_w, noselect, s);
    case 8:
      return launch_sr_variant<8>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows, L, out_w, noselect, s);
    case 16:
      return launch_sr_variant<16>(tx, ty2, tz, absd, sgn, ox, oy, oz, rows, L, out_w, noselect, s);
    default: return (int)cudaErrorInvalidValue;
  }
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

// clocks: null, or for the rounds' phases (kAddWarp..kAddPair) the
// (kRoundParts, n) int64 SM cycles of each part (round_kernel).
int bppp_chain(int phase, const int64_t* a0, const int64_t* a1, const int64_t* a2,
               const int64_t* b0, const int64_t* b1, const int64_t* b2, int64_t* out, int64_t n,
               int rep, int64_t* clocks, void* stream) {
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
#define BPPP_ROUND(P, ADD, G, S)                                                            \
  case P:                                                                                   \
    launch_round<ADD, G, S, P == kAddPair>(a0, a1, a2, b0, b1, b2, out, n, rep, clocks, s); \
    break;
    BPPP_ROUND(kAddWarp, true, 16, 1)
    BPPP_ROUND(kDblWarp, false, 16, 1)
    BPPP_ROUND(kAddSplit, true, 16, 2)
    BPPP_ROUND(kDblSplit, false, 16, 2)
    BPPP_ROUND(kAdd32S1, true, 32, 1)
    BPPP_ROUND(kDbl32S1, false, 32, 1)
    BPPP_ROUND(kAdd32S2, true, 32, 2)
    BPPP_ROUND(kDbl32S2, false, 32, 2)
    BPPP_ROUND(kAdd8S1, true, 8, 1)
    BPPP_ROUND(kAddPair, true, 16, 1)
#undef BPPP_ROUND
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
