// The MSM and basis-fold kernels of the PyTorch port, for Hopper (sm_90a).
//
// padd, horner, reduce_block, tail_horner, table_flat and select_reduce
// each replace one Pallas TPU kernel of bulletproofspp_tpu/ops/pallas_field.py;
// fold replaces the XLA fold_mul_kernel of bulletproofspp_tpu/ops/msm.py.
// All keep the contract: (16, N) int64 planes of 16-bit limbs, strict limbs
// in and out, projective (X:Y:Z) with identity (0:1:0).  Built by
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
// words in registers with 64-bit carry chains.  Making them fast (fewer
// carries, madc chains, more lanes per SM) is later work.

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

// --- padd: replaces padd_pallas / _kernel (pallas_field.py:759, :407) -----
// Lane-wise complete addition, one thread per lane.
__global__ void padd_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
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

// Horner over row sums, MSB row first: acc = 16 * acc + row(r).
template <class Row>
__device__ Pt horner_rows(Row row, int64_t rows) {
  Pt acc = pt_identity();
  for (int64_t r = 0; r < rows; r++) {
    for (int k = 0; k < 4; k++) acc = pt_dbl(acc);
    acc = pt_add(acc, row(r));
  }
  return acc;
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

// --- horner: replaces horner_pallas / _horner_kernel (:446, :419) ----------
// Input (16, batch, rows), output (16, batch); one thread per MSM.  The
// chain of 4 doublings and 1 addition per row is sequential by nature; the
// batch dimension (K stacked MSMs of one msm_many call) is the parallelism.
__global__ void horner_kernel(const int64_t* __restrict__ rx, const int64_t* __restrict__ ry,
                              const int64_t* __restrict__ rz, int64_t* __restrict__ ox,
                              int64_t* __restrict__ oy, int64_t* __restrict__ oz, int64_t batch,
                              int64_t rows) {
  int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (b >= batch) return;
  int64_t stride = batch * rows;
  auto row = [&](int64_t r) { return pt_load(rx, ry, rz, stride, b * rows + r); };
  pt_store(ox, oy, oz, batch, b, horner_rows(row, rows));
}

// --- reduce_block: replaces reduce_block_pallas / _reduce_block_kernel -----
// (:490, :474).  Narrows (16, W) by F within blocks of 128 * F lanes: output
// lane t of block k sums input lanes k*128F + t + m*128, m < F, in the Pallas
// kernel's halving order, so the projective outputs match it limb for limb.
// One thread per output lane.
template <int F>
__global__ void reduce_block_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                    const int64_t* __restrict__ z, int64_t* __restrict__ ox,
                                    int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                    int64_t w) {
  int64_t n_out = w / F;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n_out;
       j += (int64_t)gridDim.x * blockDim.x) {
    int64_t base = (j / 128) * (128 * F) + (j % 128);
    Pt v[F];
#pragma unroll
    for (int m = 0; m < F; m++) v[m] = pt_load(x, y, z, w, base + m * 128);
    halve<F>(v);
    pt_store(ox, oy, oz, n_out, j, v[0]);
  }
}

// --- tail_horner: replaces tail_horner_pallas / _tail_horner_kernel --------
// (:742, :711).  Input (16, batch, rows * 128), output (16, batch).  One
// block of 64 threads per MSM: for each row the 128 lanes halve in shared
// memory (pairs t, t + 64, then t, t + 32, ... : the order of the Pallas
// kernel's roll levels), thread 0 keeps the row sum, and after the last row
// thread 0 runs the Horner chain over the row sums.
__global__ void tail_horner_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                   const int64_t* __restrict__ z, int64_t* __restrict__ ox,
                                   int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                   int64_t batch, int64_t rows) {
  extern __shared__ Pt smem[];
  Pt* lanes = smem;        // 64
  Pt* rowsum = smem + 64;  // rows
  int t = threadIdx.x;
  int64_t b = blockIdx.x;
  int64_t stride = batch * rows * 128;
  for (int64_t r = 0; r < rows; r++) {
    int64_t base = (b * rows + r) * 128;
    lanes[t] = pt_add(pt_load(x, y, z, stride, base + t), pt_load(x, y, z, stride, base + t + 64));
    __syncthreads();
    for (int h = 32; h >= 1; h /= 2) {
      if (t < h) lanes[t] = pt_add(lanes[t], lanes[t + h]);
      __syncthreads();
    }
    if (t == 0) rowsum[r] = lanes[0];
    __syncthreads();
  }
  if (t == 0) {
    auto row = [&](int64_t r) { return rowsum[r]; };
    pt_store(ox, oy, oz, batch, b, horner_rows(row, rows));
  }
}

// --- table_flat: replaces table_flat_pallas / _table_flat_kernel -----------
// (:538, :515).  Per lane the multiples 0P..8P (7 complete additions) and
// the 9 negated Y, in the flat layout the select and fold kernels read:
// entry e, limb i, lane j at (16 e + i) * n + j, so tx and tz are (144, n)
// and ty2 is (288, n) (entries 9..17 hold -Y of 0P..8P).  One thread per
// lane; each entry is stored as soon as it is made.
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

// Entry |d| (and sign s for Y) of lane j from the flat tables.
__device__ __forceinline__ Pt table_entry(const int64_t* tx, const int64_t* ty2, const int64_t* tz,
                                          int64_t n, int64_t j, int64_t d, int64_t s) {
  Pt e;
  e.x = fe_load(tx + 16 * d * n, n, j);
  e.y = fe_load(ty2 + 16 * (d + 9 * s) * n, n, j);
  e.z = fe_load(tz + 16 * d * n, n, j);
  return e;
}

// --- select_reduce: replaces select_reduce_pallas / _select_reduce_kernel --
// (:679, :647).  Flat tables of batch * L lanes, digits absd/sgn (batch,
// rows, L); output (16, batch * rows * L / 8) row-major partials: for MSM b,
// row r and lane block k of 1,024, output lane t < 128 sums the entries
// selected by the digits of lanes k*1024 + t + m*128, m < 8, in the halving
// order of the Pallas kernel.  One thread per output lane; the selection
// is a direct read at the digit's entry (the TPU's one-hot select exists
// because its gathers are slow; the H100 gathers natively).  The reads are
// data-dependent: a warp's loads of one limb are coalesced only among the
// lanes whose digits pick the same entry, so this kernel moves more memory
// transactions per add than the others; at 1,024-4,096 lanes it still sits
// far below the card's bandwidth.
__global__ void select_reduce_kernel(const int64_t* __restrict__ tx,
                                     const int64_t* __restrict__ ty2,
                                     const int64_t* __restrict__ tz,
                                     const int64_t* __restrict__ absd,
                                     const int64_t* __restrict__ sgn, int64_t* __restrict__ ox,
                                     int64_t* __restrict__ oy, int64_t* __restrict__ oz,
                                     int64_t batch, int64_t rows, int64_t L) {
  int64_t n = batch * L, per_row = L / 8, n_out = batch * rows * per_row;
  for (int64_t o = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; o < n_out;
       o += (int64_t)gridDim.x * blockDim.x) {
    int64_t br = o / per_row, q = o % per_row;
    int64_t b = br / rows;
    int64_t lane0 = (q / 128) * 1024 + (q % 128);
    Pt v[8];
#pragma unroll
    for (int m = 0; m < 8; m++) {
      int64_t l = lane0 + m * 128;
      v[m] = table_entry(tx, ty2, tz, n, b * L + l, absd[br * L + l], sgn[br * L + l]);
    }
    halve<8>(v);
    pt_store(ox, oy, oz, n_out, o, v[0]);
  }
}

// --- fold: replaces the XLA fold_mul_kernel (bulletproofspp_tpu/ops/msm.py:247)
// Per lane b E_j + a O_j with digit streams shared by all lanes (basis
// folding and square completion): 33 rows of 4 doublings and 2 additions,
// the entries read from the lanes' flat tables (table_flat's layout).
// digits: (4, rows) = de, se, do, so.  One thread per lane; the row index
// is uniform, so the table reads of a warp are coalesced.
__global__ void fold_kernel(const int64_t* __restrict__ ex, const int64_t* __restrict__ ey2,
                            const int64_t* __restrict__ ez, const int64_t* __restrict__ ox,
                            const int64_t* __restrict__ oy2, const int64_t* __restrict__ oz,
                            const int64_t* __restrict__ digits, int64_t* __restrict__ rx,
                            int64_t* __restrict__ ry, int64_t* __restrict__ rz, int64_t n,
                            int64_t rows) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    Pt acc = pt_identity();
    for (int64_t r = 0; r < rows; r++) {
      for (int k = 0; k < 4; k++) acc = pt_dbl(acc);
      acc = pt_add(acc, table_entry(ex, ey2, ez, n, j, digits[r], digits[rows + r]));
      acc = pt_add(acc, table_entry(ox, oy2, oz, n, j, digits[2 * rows + r], digits[3 * rows + r]));
    }
    pt_store(rx, ry, rz, n, j, acc);
  }
}

}  // namespace

extern "C" {

int bppp_padd(const int64_t* x1, const int64_t* y1, const int64_t* z1, const int64_t* x2,
              const int64_t* y2, const int64_t* z2, int64_t* ox, int64_t* oy, int64_t* oz,
              int64_t n, void* stream) {
  if (n > 0) {
    padd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x1, y1, z1, x2, y2, z2, ox,
                                                                       oy, oz, n);
  }
  return (int)cudaGetLastError();
}

int bppp_horner(const int64_t* rx, const int64_t* ry, const int64_t* rz, int64_t* ox,
                int64_t* oy, int64_t* oz, int64_t batch, int64_t rows, void* stream) {
  if (batch > 0) {
    int threads = batch < 32 ? 32 : 64;
    int blocks = (int)((batch + threads - 1) / threads);
    horner_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(rx, ry, rz, ox, oy, oz, batch,
                                                                 rows);
  }
  return (int)cudaGetLastError();
}

int bppp_reduce_block(const int64_t* x, const int64_t* y, const int64_t* z, int64_t* ox,
                      int64_t* oy, int64_t* oz, int64_t w, int factor, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t n_out = w / factor;
  if (n_out > 0) {
    int blocks = blocks_for(n_out);
    switch (factor) {
      case 2:
        reduce_block_kernel<2><<<blocks, kThreads, 0, s>>>(x, y, z, ox, oy, oz, w);
        break;
      case 4:
        reduce_block_kernel<4><<<blocks, kThreads, 0, s>>>(x, y, z, ox, oy, oz, w);
        break;
      case 8:
        reduce_block_kernel<8><<<blocks, kThreads, 0, s>>>(x, y, z, ox, oy, oz, w);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

int bppp_tail_horner(const int64_t* x, const int64_t* y, const int64_t* z, int64_t* ox,
                     int64_t* oy, int64_t* oz, int64_t batch, int64_t rows, void* stream) {
  if (batch > 0) {
    size_t smem = (size_t)(64 + rows) * sizeof(Pt);
    tail_horner_kernel<<<(unsigned)batch, 64, smem, (cudaStream_t)stream>>>(x, y, z, ox, oy, oz,
                                                                            batch, rows);
  }
  return (int)cudaGetLastError();
}

int bppp_table_flat(const int64_t* px, const int64_t* py, const int64_t* pz, int64_t* tx,
                    int64_t* ty2, int64_t* tz, int64_t n, void* stream) {
  if (n > 0) {
    table_flat_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(px, py, pz, tx, ty2,
                                                                             tz, n);
  }
  return (int)cudaGetLastError();
}

int bppp_select_reduce(const int64_t* tx, const int64_t* ty2, const int64_t* tz,
                       const int64_t* absd, const int64_t* sgn, int64_t* ox, int64_t* oy,
                       int64_t* oz, int64_t batch, int64_t rows, int64_t L, void* stream) {
  if (L % 1024) return (int)cudaErrorInvalidValue;
  int64_t n_out = batch * rows * (L / 8);
  if (n_out > 0) {
    select_reduce_kernel<<<blocks_for(n_out), kThreads, 0, (cudaStream_t)stream>>>(
        tx, ty2, tz, absd, sgn, ox, oy, oz, batch, rows, L);
  }
  return (int)cudaGetLastError();
}

int bppp_fold(const int64_t* ex, const int64_t* ey2, const int64_t* ez, const int64_t* ox,
              const int64_t* oy2, const int64_t* oz, const int64_t* digits, int64_t* rx,
              int64_t* ry, int64_t* rz, int64_t n, int64_t rows, void* stream) {
  if (n > 0) {
    fold_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(ex, ey2, ez, ox, oy2, oz,
                                                                       digits, rx, ry, rz, n, rows);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
