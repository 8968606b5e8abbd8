// lanes: the small lane-wise device functions of the main paths, which the
// JAX package compiles into its device programs (XLA, no Pallas):
//  * select_small_kernel replaces msm_kernel's table select, msm._table's
//    entries picked by digit (bulletproofspp_tpu/ops/msm.py:145-156,
//    onehot_select): entry |d| of X and Z, |d| + 9 s of Y.  No MSM route
//    launches it: under 128 lanes reduce_lanes, from 128 to 1,023 the first
//    reduce_block or tail_rows launch (csrc/kernels.cu) selects the same
//    words itself, through the same gather (curve.cuh: selected_point).  It
//    stays as the unfused route those are held and timed against;
//  * endo_kernel replaces curve.endo (bulletproofspp_tpu/ops/curve.py:251),
//    phi(x, y, z) = (beta x, y, z), and with `interleave` the engine's
//    _interleave_endo (bulletproofspp_tpu/ops/engine.py:119): [P_j, phi(P_j)]
//    at lanes 2j and 2j + 1 of the three planes, in the same launch;
//  * pneg_kernel replaces curve.pneg (bulletproofspp_tpu/ops/curve.py:87),
//    -y a lane (fe_neg: strict, -0 may come out as 0 or Q).  No path
//    launches it, nor endo without the interleave, since complete_square
//    (csrc/kernels.cu) makes phi and the negation of the square completion
//    in its own launch; both stay as its unfused route's yardsticks;
//  * normalize3_kernel replaces curve._normalize3 (bulletproofspp_tpu/ops/
//    curve.py:124): three strict planes to one stacked (3, 16, n) canonical
//    tensor, ready for one device-to-host copy (curve.to_affine_host; an
//    MSM's result comes out canonical from horner_warp_kernel's last warp
//    instead, csrc/kernels.cu);
//  * assemble_kernel replaces the entry assembly that the JAX package
//    compiles into its oracle step (_assemble_many_body, bulletproofspp_tpu/
//    ops/engine.py:186, inlined by _msm_many_norm, :223) and into its
//    lockstep fold (_assemble_fold, :159), with _dp_pad / _identity_cols
//    (:97-117) and _split3 (:147): every entry's segments (slices of base
//    vectors, any strides) end to end, padded with the identity to L lanes,
//    entries stacked, and with `interleave` [P_j, phi(P_j)] at lanes 2j and
//    2j + 1, in one launch (one a run of consecutive entries where the
//    table outgrows a launch's parameters) where the eager route took a
//    slice, a concat, a pad (three fills and a concat) and a stack each,
//    then an endo launch.
// Equal to ops/kernels.py: select_plain (word for word), endo_plain and
// pneg_plain (after normalization), normalize3_plain (word for word) and
// assemble_plain (word for word; the phi lanes after normalization, their
// words endo_kernel's).
//
// What bounds them on the H100: a launch's fixed cost (assemble at the
// 2^21-lane MSM and endo's interleave of the bench's basis and the sharded
// MSM's 2^20 pairs: their bytes).  Each moves a few KB
// to a few MB (a 16- to 512-lane MSM's selected entries, a few thousand
// lanes of points), and endo's one field product a lane is far below the
// multiply rate.  As plain PyTorch on the card each was a chain of 17 to 190
// small operator launches; here each is one launch, one thread a lane (a
// (MSM, row, lane) for the select) in a grid-stride loop, neighbouring
// threads on neighbouring lanes, so every limb row is read and written in
// whole sectors.
//
// Planes: (16, n) int64 of 16-bit limbs, strict in (not canonical: values in
// [Q, 2^256) and saturated 0xFFFF limbs occur).  Flat tables: entry e, limb i
// of lane c at row 16 e + i of a (16 E, B L) plane (table_flat's layout);
// digits (B, rows, L) uint8, |d| in 0..8 and s in {0, 1}.
//
// assemble's table: the segments' addresses and strides are known only on
// the host, so they travel in the launch itself: a __grid_constant__ struct
// in parameter space (AssembleTable), read through the constant cache, with
// no device buffer, no host-to-device copy and nothing whose lifetime must
// outlast the enqueue.  The table is compact (32-bit strides, counts and
// starts: 56 bytes a segment) and comes in three size tiers, so the
// commonest call (2-3 segments, under 256 bytes) does not push the largest
// struct.  The largest is what the toolkit allows: 32,764 bytes of
// parameters from CUDA 12.1 on (sm_70 and later), else 4,096; a call whose
// table does not fit is split by the wrapper into launches over consecutive
// entries, which are independent (ops/kernels.py: _assemble_launches; a
// 130-entry oracle step of 4 groups an entry, ~520 segments, fits in one).
// One thread a unit: output lane u of an entry, or with `interleave` lanes
// 2u and 2u + 1; neighbouring threads hold neighbouring lanes, so every
// limb row is written in whole sectors and read in whole (stride 1) or half
// (stride 2) sectors.  A thread finds its segment among its entry's by the
// starts and counts in the struct (the threads of a warp read the words of
// one or a few entries: broadcasts), then issues all 48 limbs of its point before its
// first store.  P lanes, the interleave's y and z, and the identity's limbs
// are copied as they are; phi's x is fe_mul(x, beta), endo_kernel's words.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "curve.cuh"

using namespace bppp;

namespace {

constexpr int kThreads = 256;
constexpr int kLimbs = 16;

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b > 65535 * 16 ? 65535 * 16 : b);
}

__device__ __forceinline__ int64_t first_lane() {
  return blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t lane_stride() { return (int64_t)gridDim.x * blockDim.x; }

// One thread a (MSM b, row r, lane l), j = (b rows + r) L + l: the point
// its digit selects (curve.cuh: selected_point, the one gather of every
// select on the MSM routes), stored.
__global__ void select_small_kernel(const int64_t* __restrict__ tx, const int64_t* __restrict__ ty2,
                                    const int64_t* __restrict__ tz,
                                    const uint8_t* __restrict__ absd,
                                    const uint8_t* __restrict__ sgn, int64_t* __restrict__ ox,
                                    int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                    int64_t batch, int64_t rows, int64_t L) {
  const int64_t m = batch * rows * L;  // selected lanes
  const int64_t n = batch * L;         // table lanes
  for (int64_t j = first_lane(); j < m; j += lane_stride()) {
    pt_store(ox, oy, oz, m, j, selected_point(tx, ty2, tz, absd, sgn, n, rows, L, j));
  }
}

// a at lane 2j and b at lane 2j + 1 of (16, 2n) planes (fe_store's limbs):
// the two limbs of a row side by side, one 16-byte store (the planes are
// 16-byte aligned and 2j is even), so a warp writes 512 contiguous bytes a
// row.
__device__ __forceinline__ void fe_store_pair(int64_t* p, int64_t n, int64_t j, const Fe& a,
                                              const Fe& b) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    *reinterpret_cast<longlong2*>(p + (2 * k) * 2 * n + 2 * j) =
        make_longlong2(a.w[k] & 0xffffu, b.w[k] & 0xffffu);
    *reinterpret_cast<longlong2*>(p + (2 * k + 1) * 2 * n + 2 * j) =
        make_longlong2(a.w[k] >> 16, b.w[k] >> 16);
  }
}

// beta x a lane; with interleave, lanes 2j and 2j + 1 of the (16, 2n) planes
// get (x, y, z) and (beta x, y, z) of lane j.  The interleave is bound by
// its bytes (384 in, 768 out a lane): stored limb by limb at stride 2 (a
// warp's store 256 bytes spread over 512) it reached 0.47 of its bound at
// 2^20 lanes; fe_store_pair writes each row's two lanes in one store.
__global__ void endo_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                            const int64_t* __restrict__ z, int64_t* __restrict__ ox,
                            int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t n,
                            int interleave) {
  for (int64_t j = first_lane(); j < n; j += lane_stride()) {
    const Fe xv = fe_load(x, n, j);
    const Fe bx = fe_mul(xv, fe_beta());
    if (!interleave) {
      fe_store(ox, n, j, bx);
      continue;
    }
    const Fe yv = fe_load(y, n, j), zv = fe_load(z, n, j);
    fe_store_pair(ox, n, j, xv, bx);
    fe_store_pair(oy, n, j, yv, yv);
    fe_store_pair(oz, n, j, zv, zv);
  }
}

__global__ void pneg_kernel(const int64_t* __restrict__ y, int64_t* __restrict__ out, int64_t n) {
  for (int64_t j = first_lane(); j < n; j += lane_stride()) {
    fe_store(out, n, j, fe_neg(fe_load(y, n, j)));
  }
}

// out: (3, 16, n), plane c at c 16 n
__global__ void normalize3_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                  const int64_t* __restrict__ z, int64_t* __restrict__ out,
                                  int64_t n) {
  for (int64_t j = first_lane(); j < n; j += lane_stride()) {
    fe_store(out, n, j, fe_canon(fe_load(x, n, j)));
    fe_store(out + kLimbs * n, n, j, fe_canon(fe_load(y, n, j)));
    fe_store(out + 2 * kLimbs * n, n, j, fe_canon(fe_load(z, n, j)));
  }
}

// assemble's table (ops/kernels.py: _assemble_launches packs it), bytes
// of a little-endian image: int32 start[n_entries + 1] (entry e's segments
// are start[e] .. start[e + 1] - 1 of this launch), padded to 8 bytes,
// then one Seg a segment.
struct Seg {
  const int64_t* c[3];   // the first lane's limb 0 of x, y and z
  int32_t rs[3], ls[3];  // their row and lane strides, in elements
  int32_t n, first;      // lanes, and the first one's lane in its entry
};
static_assert(sizeof(Seg) == 56, "ops/kernels.py: _SEG");

#if CUDART_VERSION >= 12010
constexpr int kParamLimit = 32764;  // kernel parameters from CUDA 12.1 (sm_70 and later)
#else
constexpr int kParamLimit = 4096;
#endif

// The launch's one parameter: outputs and shape, then the table.  Output
// entry e = s K + k of the S (16, K, L) outputs lies at s 16 K L + k L,
// limb rows K L apart.
template <int kBytes>
struct AssembleTable {
  int64_t* out[3];
  int32_t entry0, n_entries, K, L, interleave, pad;
  alignas(8) unsigned char bytes[kBytes];
};
constexpr int kHeader = sizeof(AssembleTable<8>) - 8;
constexpr int kMaxTable = (kParamLimit - kHeader) / 8 * 8;  // ops/kernels.py: assemble_capacity
constexpr int kTiers[3] = {256, 2048, kMaxTable};
static_assert(sizeof(AssembleTable<kMaxTable>) <= kParamLimit, "parameter space");

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
    assemble_kernel(const __grid_constant__ AssembleTable<kBytes> t) {
  const int64_t w = t.interleave ? 2 : 1, units = t.L / w, row = (int64_t)t.K * t.L;
  const int32_t* start = reinterpret_cast<const int32_t*>(t.bytes);
  const Seg* segs = reinterpret_cast<const Seg*>(t.bytes + ((t.n_entries + 1) * 4 + 7) / 8 * 8);
  for (int64_t q = first_lane(); q < t.n_entries * units; q += lane_stride()) {
    const int64_t el = q / units, u = q % units, e = t.entry0 + el;
    const int64_t base = (e / t.K) * kLimbs * row + (e % t.K) * t.L + w * u;
    int s = -1;
    for (int i = start[el]; i < start[el + 1]; i++) {
      if (u >= segs[i].first && u < segs[i].first + segs[i].n) {
        s = i;
        break;
      }
    }
    if (s < 0) {  // past the entry's segments: the identity (0 : 1 : 0)
#pragma unroll
      for (int i = 0; i < kLimbs; i++) {
        for (int64_t k = 0; k < w; k++) {
          t.out[0][i * row + base + k] = 0;
          t.out[1][i * row + base + k] = i == 0;
          t.out[2][i * row + base + k] = 0;
        }
      }
      continue;
    }
    const Seg& g = segs[s];
    const int64_t j = u - g.first;
    // all 48 limbs in flight before the first store: the compiler cannot
    // tell that a source never aliases an output, so a load after a store
    // would wait for the one before it
    int64_t v[3][kLimbs];
#pragma unroll
    for (int c = 0; c < 3; c++) {
      const int64_t* src = g.c[c] + j * g.ls[c];
#pragma unroll
      for (int i = 0; i < kLimbs; i++) v[c][i] = src[i * g.rs[c]];
    }
#pragma unroll
    for (int c = 0; c < 3; c++) {
#pragma unroll
      for (int i = 0; i < kLimbs; i++) {
        t.out[c][i * row + base] = v[c][i];
        if (t.interleave && c > 0) t.out[c][i * row + base + 1] = v[c][i];
      }
    }
    if (t.interleave) {  // phi's x: fe_load's words, times beta
      Fe x;
#pragma unroll
      for (int k = 0; k < 8; k++) {
        x.w[k] = ((u32)v[0][2 * k] & 0xffffu) | ((u32)v[0][2 * k + 1] << 16);
      }
      fe_store(t.out[0] + 1, row, base, fe_mul(x, fe_beta()));
    }
  }
}

template <int kBytes>
int launch_assemble(const void* table, int64_t bytes, int64_t* ox, int64_t* oy, int64_t* oz,
                    int64_t entry0, int64_t n_entries, int64_t K, int64_t L, int interleave,
                    cudaStream_t stream, int64_t units) {
  AssembleTable<kBytes> t;
  t.out[0] = ox, t.out[1] = oy, t.out[2] = oz;
  t.entry0 = (int32_t)entry0, t.n_entries = (int32_t)n_entries, t.K = (int32_t)K;
  t.L = (int32_t)L, t.interleave = interleave, t.pad = 0;
  std::memcpy(t.bytes, table, bytes);
  assemble_kernel<kBytes><<<blocks_for(units), kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bppp_select_small(const int64_t* tx, const int64_t* ty2, const int64_t* tz,
                      const uint8_t* absd, const uint8_t* sgn, int64_t* ox, int64_t* oy,
                      int64_t* oz, int64_t batch, int64_t rows, int64_t L, void* stream) {
  const int64_t m = batch * rows * L;
  if (m > 0) {
    select_small_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
        tx, ty2, tz, absd, sgn, ox, oy, oz, batch, rows, L);
  }
  return (int)cudaGetLastError();
}

int bppp_endo(const int64_t* x, const int64_t* y, const int64_t* z, int64_t* ox, int64_t* oy,
              int64_t* oz, int64_t n, int interleave, void* stream) {
  if (n > 0) {
    endo_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, y, z, ox, oy, oz, n,
                                                                      interleave);
  }
  return (int)cudaGetLastError();
}

int bppp_pneg(const int64_t* y, int64_t* out, int64_t n, void* stream) {
  if (n > 0) pneg_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(y, out, n);
  return (int)cudaGetLastError();
}

int bppp_normalize3(const int64_t* x, const int64_t* y, const int64_t* z, int64_t* out, int64_t n,
                    void* stream) {
  if (n > 0) normalize3_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, y, z, out, n);
  return (int)cudaGetLastError();
}

// The bytes of segment table one launch carries (the largest tier).
int64_t bppp_assemble_capacity() { return kMaxTable; }

// table: `bytes` of this launch's segment table on the host (AssembleTable's
// layout), copied into the launch's
// parameter struct of the smallest tier that holds it; the launch writes
// entries entry0 .. entry0 + n_entries - 1 of the S (16, K, L) planes of
// each coordinate.
int bppp_assemble(const void* table, int64_t bytes, int64_t* ox, int64_t* oy, int64_t* oz,
                  int64_t entry0, int64_t n_entries, int64_t K, int64_t L, int interleave,
                  void* stream) {
  if (K < 1 || entry0 < 0 || n_entries < 0 || L < 0 || (interleave && L % 2) || bytes < 0 ||
      bytes > kMaxTable || entry0 + n_entries > INT32_MAX || K > INT32_MAX || L > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t units = n_entries * (interleave ? L / 2 : L);
  if (units == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
#define BPPP_ASSEMBLE(B) \
  launch_assemble<B>(table, bytes, ox, oy, oz, entry0, n_entries, K, L, interleave, s, units)
  return bytes <= kTiers[0] ? BPPP_ASSEMBLE(kTiers[0])
       : bytes <= kTiers[1] ? BPPP_ASSEMBLE(kTiers[1]) : BPPP_ASSEMBLE(kTiers[2]);
#undef BPPP_ASSEMBLE
}

}  // extern "C"
