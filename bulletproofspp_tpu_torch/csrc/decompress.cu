// decompress: replaces the XLA-only decompress_kernel
// (bulletproofspp_tpu/ops/curve.py:224), the batched point decompression of
// proof decoding.
//
// Per lane j: v = x^3 + 7, r = v^((p+1)/4), ok = (r^2 == v), and y the
// canonical root picked by the sign bit (y is the larger of r and p - r as
// integers iff sign is 1), exactly as ops/kernels.py: decompress_plain; y is
// defined on non-residue lanes too.  x (16, n) strict int64 planes, sign
// (n,) int64; y (16, n) canonical, ok (n,) bool (one byte each).
//
// What bounds it on the H100: the latency of one lane's chain of dependent
// field products, the exponentiation.  One thread per lane: at the batch's
// 16,384 lanes that is about one warp per SM sub-partition, and cli test
// decodes 16 to 64 lanes, one warp; at every width each scheduler has one
// warp's dependent products to issue, far from both the multiply and the
// bytes bound.  So the design shortens the chain and each link of it:
//  * an addition chain for (p+1)/4 (libsecp256k1's secp256k1_fe_sqrt; the
//    exponent is three blocks of ones, of lengths 2, 22 and 223): 253
//    squarings and 13 multiplications, where square-and-multiply over its
//    bits took 253 and 246.  The steps are bounds.py: SQRT_CHAIN, which a
//    test evaluates on integers;
//  * each squaring through field.cuh: fe_sqr, 36 word products (the cross
//    products once, doubled) where fe_mul forms 64, on the same aligned
//    word pairs and carry chains.
// The exponent's steps are the same for every lane: no divergence.
// decompress emits only the canonical y and ok (fe_eq canonicalises), so
// fe_sqr's representatives, not fe_mul's, give the same bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

using namespace bppp;

namespace {

constexpr int kThreads = 128;

// a^((p+1)/4): the ladder (field.cuh: fe_ladder), then three steps of its
// own; (s, k) as in bounds.py SQRT_CHAIN, in its order.
__device__ Fe fe_sqrt_candidate(const Fe& a) {
  const FeLadder l = fe_ladder(a);                     // the ladder's 11 steps
  Fe t = fe_mul(fe_sqr_n(l.x223, 23), l.x22);          // (23, 22)
  t = fe_mul(fe_sqr_n(t, 6), l.x2);                    // (6, 2)
  return fe_sqr_n(t, 2);                               // (2, 0)
}

__global__ void decompress_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ sign,
                                  int64_t* __restrict__ y, uint8_t* __restrict__ ok, int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    const Fe xv = fe_load(x, n, j);
    Fe seven = fe_zero();
    seven.w[0] = 7;
    const Fe v = fe_add(fe_mul(fe_sqr(xv), xv), seven);
    const Fe r = fe_sqrt_candidate(v);
    ok[j] = fe_eq(fe_sqr(r), v) ? 1 : 0;
    const Fe rn = fe_canon(r), nn = fe_canon(fe_neg(r));
    const bool big = fe_gt(rn, nn);
    fe_store(y, n, j, big == (sign[j] > 0) ? rn : nn);
  }
}

}  // namespace

extern "C" {

int bppp_decompress(const int64_t* x, const int64_t* sign, int64_t* y, uint8_t* ok, int64_t n,
                    void* stream) {
  if (n > 0) {
    int64_t b = (n + kThreads - 1) / kThreads;
    int blocks = (int)(b > 65535 * 16 ? 65535 * 16 : b);
    decompress_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, sign, y, ok, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
