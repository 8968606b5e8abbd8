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
// What bounds it on the H100: the exponentiation, a chain of 253 squarings
// and 246 multiplications per lane (the plain version runs it as ~500 field
// products of tens of PyTorch launches each).  One thread per lane with the
// exponent's bits uniform across the warp, so there is no divergence; at
// batch-decode widths (16,384 lanes) that is 128 blocks, about one per SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

using namespace bppp;

namespace {

constexpr int kThreads = 128;

// (p + 1) / 4 = 2^254 - 2^30 - 244, little-endian words; bit 253 is its top
__constant__ u32 kSqrtExp[8] = {0xbfffff0cu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                                0xffffffffu, 0xffffffffu, 0xffffffffu, 0x3fffffffu};

// a^((p+1)/4) by square-and-multiply from the top bit down
__device__ Fe fe_sqrt_candidate(const Fe& a) {
  Fe r = a;
  for (int bit = 252; bit >= 0; bit--) {
    r = fe_mul(r, r);
    if ((kSqrtExp[bit >> 5] >> (bit & 31)) & 1u) r = fe_mul(r, a);
  }
  return r;
}

__global__ void decompress_kernel(const int64_t* __restrict__ x, const int64_t* __restrict__ sign,
                                  int64_t* __restrict__ y, uint8_t* __restrict__ ok, int64_t n) {
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x) {
    const Fe xv = fe_load(x, n, j);
    Fe seven = fe_zero();
    seven.w[0] = 7;
    const Fe v = fe_add(fe_mul(fe_mul(xv, xv), xv), seven);
    const Fe r = fe_sqrt_candidate(v);
    ok[j] = fe_eq(fe_mul(r, r), v) ? 1 : 0;
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
