// affine: the device affine conversion that the JAX package's fold_bases and
// shared_mul take (bulletproofspp_tpu/ops/msm.py:313-321: run_fold, then
// curve.to_affine), XLA-only functions there:
//  * inv_kernel replaces limb.inv (bulletproofspp_tpu/ops/limb.py:371), the
//    inverse with 0 -> 0 (Fermat's a^(p-2) there), and on the card serves
//    limb.batch_inv (:424) as well;
//  * to_affine_kernel replaces curve.to_affine (bulletproofspp_tpu/ops/
//    curve.py:156): x z^-1 and y z^-1 canonical, and inf where z = 0 mod p
//    (x and y 0 there, as the JAX package's mul(x, 0) gives).
// Both exactly as ops/kernels.py: inv_plain and to_affine_plain.
//
// What bounds them on the H100: the latency of one lane's inverse, a chain of
// dependent steps.  Fermat's a^(p-2) as libsecp256k1's addition chain (255
// squarings and 15 multiplications, each waiting on the one before) took
// ~0.35 us a product, 0.093 ms at every width from 16 to 4,096 lanes (NVIDIA
// H100 80GB HBM3, 700 W).  The inverse is field.cuh: fe_inv_divsteps,
// Bernstein and Yang's safegcd as libsecp256k1's secp256k1_modinv32 runs it,
// in its constant-time schedule (every input here is the Z of a public point,
// but a fixed schedule keeps the lanes of a warp together): 20 batches of 30
// divsteps on one word each (adds, logic and shifts, no multiply), each batch
// followed by a 2x2 matrix applied to 9 limbs of 30 bits (bounds.py:
// DIVSTEP_BATCHES, INV).  A divstep waits on the one before through a few
// one-cycle integer operations, not through a 256-bit product, so the chain
// is a fraction of Fermat's; its work is ~3,000 multiplies and ~16,000
// integer operations a lane, against ~27,000 multiplies.  One thread per lane:
// at fold_bases' 16 to 4,096 lanes that is at most one warp per SM
// sub-partition, latency-bound; at 65,536 lanes four warps a sub-partition
// share its issue.  The JAX package's batch_inv uses Montgomery's trick
// (prefix and suffix products, one inverse), which saves products, not
// latency; each lane runs its own inverse here (the inverse is unique: the
// same canonical words).
//
// Planes: (16, n) int64 of 16-bit limbs, strict in (fold's and fold_many's
// outputs as they come, not normalized), canonical out; inf (n,) bool, one
// byte each.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

using namespace bppp;

namespace {

constexpr int kThreads = 128;

__global__ void inv_kernel(const int64_t* __restrict__ a, int64_t* __restrict__ out, int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    fe_store(out, n, j, fe_inv_divsteps(fe_load(a, n, j)));
  }
}

__global__ void to_affine_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                 const int64_t* __restrict__ z, int64_t* __restrict__ ax,
                                 int64_t* __restrict__ ay, uint8_t* __restrict__ inf, int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    const Fe zv = fe_load(z, n, j);
    const Fe zi = fe_inv_divsteps(zv);  // 0 where z = 0 mod p
    fe_store(ax, n, j, fe_canon(fe_mul(fe_load(x, n, j), zi)));
    fe_store(ay, n, j, fe_canon(fe_mul(fe_load(y, n, j), zi)));
    inf[j] = fe_eq(zv, fe_zero()) ? 1 : 0;
  }
}

int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b > 65535 * 16 ? 65535 * 16 : b);
}

}  // namespace

extern "C" {

int bppp_inv(const int64_t* a, int64_t* out, int64_t n, void* stream) {
  if (n > 0) inv_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}

int bppp_to_affine(const int64_t* x, const int64_t* y, const int64_t* z, int64_t* ax, int64_t* ay,
                   uint8_t* inf, int64_t n, void* stream) {
  if (n > 0) {
    to_affine_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(x, y, z, ax, ay, inf,
                                                                           n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
