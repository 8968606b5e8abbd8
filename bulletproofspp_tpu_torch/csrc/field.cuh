// secp256k1 base field Fq = 2^256 - 2^32 - 977 as __device__ functions.
//
// Inside a kernel an element is 8 little-endian 32-bit words; every function
// returns a value < 2^256 (not necessarily < p), which is the "strict" form
// of the port's limb planes.  Products use 32x32->64 multiplies with 64-bit
// carry chains, and the reduction folds the high half through
// 2^256 = 2^32 + 977 (mod p).  Integers only.
//
// At the kernel boundary the layout is fixed: (16, N) int64 planes of
// 16-bit limbs (limb i of lane j at i * stride + j), strict in and out.
// The port's plain PyTorch field (ops/limb.py) computes the same values
// mod p; outputs are compared after normalization.
#pragma once

#include <cstdint>

namespace bppp {

typedef uint32_t u32;
typedef uint64_t u64;

struct Fe {
  u32 w[8];
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = 0;
  return r;
}

__device__ __forceinline__ Fe fe_one() {
  Fe r = fe_zero();
  r.w[0] = 1;
  return r;
}

// limb planes -> words: word k = limb 2k | limb 2k+1 << 16
__device__ __forceinline__ Fe fe_load(const int64_t* p, int64_t stride, int64_t j) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    u32 lo = (u32)p[(2 * k) * stride + j];
    u32 hi = (u32)p[(2 * k + 1) * stride + j];
    r.w[k] = (lo & 0xffffu) | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void fe_store(int64_t* p, int64_t stride, int64_t j, const Fe& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p[(2 * k) * stride + j] = (int64_t)(a.w[k] & 0xffffu);
    p[(2 * k + 1) * stride + j] = (int64_t)(a.w[k] >> 16);
  }
}

// r + c * (2^32 + 977), c < 2^35, wrapped below 2^256.  If the first
// addition carries out of 2^256, the remainder is < c * C < 2^68, so adding
// C once more cannot carry again.
__device__ __forceinline__ void fe_fold(Fe& r, u64 c) {
  u64 m = c * 977u;  // < 2^45
  u64 acc = (u64)r.w[0] + (m & 0xffffffffu);
  r.w[0] = (u32)acc;
  acc >>= 32;
  acc += (u64)r.w[1] + (m >> 32) + (c & 0xffffffffu);
  r.w[1] = (u32)acc;
  acc >>= 32;
  acc += (u64)r.w[2] + (c >> 32);
  r.w[2] = (u32)acc;
  acc >>= 32;
#pragma unroll
  for (int k = 3; k < 8; k++) {
    acc += r.w[k];
    r.w[k] = (u32)acc;
    acc >>= 32;
  }
  u32 o = (u32)acc;  // 0 or 1
  acc = (u64)r.w[0] + (u64)o * 977u;
  r.w[0] = (u32)acc;
  acc >>= 32;
  acc += (u64)r.w[1] + o;
  r.w[1] = (u32)acc;
  acc >>= 32;
#pragma unroll
  for (int k = 2; k < 8; k++) {
    acc += r.w[k];
    r.w[k] = (u32)acc;
    acc >>= 32;
  }
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  u64 acc = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    acc += (u64)a.w[k] + b.w[k];
    r.w[k] = (u32)acc;
    acc >>= 32;
  }
  fe_fold(r, acc);
  return r;
}

// r - o * (2^32 + 977) with o in {0, 1}; returns the borrow out of 2^256.
__device__ __forceinline__ u32 fe_sub_c(Fe& r, u32 o) {
  int64_t t = (int64_t)r.w[0] - (int64_t)o * 977;
  r.w[0] = (u32)t;
  t >>= 32;  // arithmetic: 0 or -1
  t += (int64_t)r.w[1] - (int64_t)o;
  r.w[1] = (u32)t;
  t >>= 32;
#pragma unroll
  for (int k = 2; k < 8; k++) {
    t += (int64_t)r.w[k];
    r.w[k] = (u32)t;
    t >>= 32;
  }
  return (u32)(-t);
}

// a - b: on a borrow the wrapped result r = a - b + 2^256 is corrected by
// subtracting C (a - b + p = r - C); if that borrows again, r < C and the
// new wrapped value is >= 2^256 - C > C, so a second C never borrows.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  int64_t t = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    t += (int64_t)a.w[k] - (int64_t)b.w[k];
    r.w[k] = (u32)t;
    t >>= 32;
  }
  u32 borrow = fe_sub_c(r, (u32)(-t));
  fe_sub_c(r, borrow);
  return r;
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) { return fe_sub(fe_zero(), a); }

// Reduce a 512-bit product t[0..15] (words) mod p to < 2^256:
// T = L + H * 2^256 = L + H * 977 + H * 2^32 (mod p).
__device__ __forceinline__ Fe fe_reduce512(const u32* t) {
  Fe r;
  u64 acc = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    acc += (u64)t[k] + (u64)t[8 + k] * 977u;  // < 2^43 with the carry
    if (k > 0) acc += t[7 + k];
    r.w[k] = (u32)acc;
    acc >>= 32;
  }
  fe_fold(r, acc + t[15]);  // < 2^11 + 2^32
  return r;
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  u32 t[16];
#pragma unroll
  for (int k = 0; k < 16; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    u64 c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      // (2^32-1)^2 + 2 (2^32-1) = 2^64 - 1: never overflows
      c += (u64)a.w[i] * b.w[j] + t[i + j];
      t[i + j] = (u32)c;
      c >>= 32;
    }
    t[i + 8] = (u32)c;
  }
  return fe_reduce512(t);
}

__device__ __forceinline__ Fe fe_mul_small(const Fe& a, u32 k) {
  Fe r;
  u64 acc = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    acc += (u64)a.w[i] * k;
    r.w[i] = (u32)acc;
    acc >>= 32;
  }
  fe_fold(r, acc);
  return r;
}

}  // namespace bppp
