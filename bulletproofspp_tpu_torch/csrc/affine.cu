// affine: the device affine conversion that the JAX package's fold_bases and
// shared_mul take (bulletproofspp_tpu/ops/msm.py:313-321: run_fold, then
// curve.to_affine), XLA-only functions there:
//  * inv_kernel replaces limb.inv (bulletproofspp_tpu/ops/limb.py:371), the
//    Fermat inverse a^(p-2) with 0 -> 0, and on the card serves limb.batch_inv
//    (:424) as well;
//  * to_affine_kernel replaces curve.to_affine (bulletproofspp_tpu/ops/
//    curve.py:156): x z^-1 and y z^-1 canonical, and inf where z = 0 mod p
//    (x and y 0 there, as the JAX package's mul(x, 0) gives).
// Both exactly as ops/kernels.py: inv_plain and to_affine_plain.
//
// What bounds them on the H100: the latency of one lane's chain of dependent
// field products, as in decompress.  The inverse is field.cuh: fe_inv,
// libsecp256k1's addition chain for p - 2 (bounds.py: INV_CHAIN): 255
// squarings (fe_sqr, 36 word products) and 15 multiplications, each waiting
// on the one before; to_affine adds one product.  One thread per lane: at
// fold_bases' 16 to 4,096 lanes that is at most one warp per SM
// sub-partition, each scheduler issuing one warp's dependent products, far
// from both the multiply and the bytes bound.  The JAX package's batch_inv
// uses Montgomery's trick (prefix and suffix products, one inverse), which
// saves products, not latency: its one inverse is the same chain of 270
// dependent products, and the scans add log2 L steps of products on top.  So
// each lane runs its own inverse (the inverse is unique: the same canonical
// words), and one chain of 270 dependent products bounds either design.
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
    fe_store(out, n, j, fe_canon(fe_inv(fe_load(a, n, j))));
  }
}

__global__ void to_affine_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ y,
                                 const int64_t* __restrict__ z, int64_t* __restrict__ ax,
                                 int64_t* __restrict__ ay, uint8_t* __restrict__ inf, int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    const Fe zv = fe_load(z, n, j);
    const Fe zi = fe_inv(zv);  // = 0 mod p where z = 0 mod p
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
