// secp256k1 base field Fq = 2^256 - 2^32 - 977 as __device__ functions.
//
// Inside a kernel an element is 8 little-endian 32-bit words; every function
// returns a value < 2^256 (not necessarily < p), which is the "strict" form
// of the port's limb planes; fe_canon gives the value < p.  Products use 32x32->64 multiplies with 64-bit
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

// The 512-bit product a * b into t[0..15] (words), schoolbook.
__device__ __forceinline__ void fe_mul_wide(const Fe& a, const Fe& b, u32* t) {
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
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  u32 t[16];
  fe_mul_wide(a, b, t);
  return fe_reduce512(t);
}

// a^2 mod p, strict, for decompress's square-root chain.  36 word products
// (each cross product a_i a_j, i < j, once, then doubled, and the 8 squares)
// against fe_mul's 64, summed by columns: column k holds the low words of
// the products of weight k and the high words of those of weight k - 1, as
// a 64-bit sum of 32-bit halves.  No product waits on another, and a
// column's sum waits only on its own (at most 8 halves), where fe_mul's
// schoolbook runs one carry through every product of a row.  Each column
// is < 2^37 (at most 8 halves, doubled, plus a square's half), so the
// columns go into the reduction without a carry pass of their own:
// T = L + 977 H + 2^32 H (mod p), as in fe_reduce512.  Equal to fe_mul(a,
// a) mod p (not necessarily the same representative).
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  u64 col[16];
#pragma unroll
  for (int k = 0; k < 16; k++) col[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int j = i + 1; j < 8; j++) {
      const u64 p = (u64)a.w[i] * a.w[j];
      col[i + j] += (u32)p;
      col[i + j + 1] += p >> 32;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const u64 s = (u64)a.w[i] * a.w[i];
    col[2 * i] = 2 * col[2 * i] + (u32)s;
    col[2 * i + 1] = 2 * col[2 * i + 1] + (s >> 32);
  }
  Fe r;
  u64 acc = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    // one addition waits on the carry; the column sum beside it does not
    acc += col[k] + col[8 + k] * 977u + (k > 0 ? col[7 + k] : 0);  // < 2^47
    r.w[k] = (u32)acc;
    acc >>= 32;
  }
  fe_fold(r, acc + col[15]);  // col[15] is the high word of a_7^2: < 2^15 + 2^32
  return r;
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

// a^(2^n) by n squarings
__device__ __forceinline__ Fe fe_sqr_n(Fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) a = fe_sqr(a);
  return a;
}

// libsecp256k1's addition chains for the square root (decompress.cu:
// fe_sqrt_candidate) and the inverse (fe_inv) share their first 11 steps, the
// ladder below: xk = a^(2^k - 1), each step squaring the last result s times
// and multiplying it by xk, (s, k) in the comments (bounds.py: SQRT_CHAIN and
// INV_CHAIN).  The two chains then take their products from x2, x3, x22 and
// x223 (and a = x1).
struct FeLadder {
  Fe x2, x3, x22, x223;
};

__device__ __forceinline__ FeLadder fe_ladder(const Fe& a) {
  FeLadder l;
  l.x2 = fe_mul(fe_sqr(a), a);                        // (1, 1)
  l.x3 = fe_mul(fe_sqr(l.x2), a);                     // (1, 1)
  const Fe x6 = fe_mul(fe_sqr_n(l.x3, 3), l.x3);      // (3, 3)
  const Fe x9 = fe_mul(fe_sqr_n(x6, 3), l.x3);        // (3, 3)
  const Fe x11 = fe_mul(fe_sqr_n(x9, 2), l.x2);       // (2, 2)
  l.x22 = fe_mul(fe_sqr_n(x11, 11), x11);             // (11, 11)
  const Fe x44 = fe_mul(fe_sqr_n(l.x22, 22), l.x22);  // (22, 22)
  const Fe x88 = fe_mul(fe_sqr_n(x44, 44), x44);      // (44, 44)
  const Fe x176 = fe_mul(fe_sqr_n(x88, 88), x88);     // (88, 88)
  const Fe x220 = fe_mul(fe_sqr_n(x176, 44), x44);    // (44, 44)
  l.x223 = fe_mul(fe_sqr_n(x220, 3), l.x3);           // (3, 3)
  return l;
}

// a^(p-2) = a^-1 mod p, strict; 0 -> 0 (every step multiplies by a power of
// a).  p - 2 in binary is blocks of ones of lengths 223, 22, 1, 2 and 1: the
// ladder, then four steps.  255 squarings and 15 multiplications.
__device__ __forceinline__ Fe fe_inv(const Fe& a) {
  const FeLadder l = fe_ladder(a);                    // the ladder's 11 steps
  Fe t = fe_mul(fe_sqr_n(l.x223, 23), l.x22);         // (23, 22)
  t = fe_mul(fe_sqr_n(t, 5), a);                      // (5, 1)
  t = fe_mul(fe_sqr_n(t, 3), l.x2);                   // (3, 2)
  return fe_mul(fe_sqr_n(t, 2), a);                   // (2, 1)
}

// Strict -> canonical (< p): a >= p iff a + C carries out of 2^256, and then
// the low 256 bits of a + C are a - p (a < 2^256 < 2p, so once is enough).
__device__ __forceinline__ Fe fe_canon(const Fe& a) {
  Fe r;
  u64 acc = (u64)a.w[0] + 977u;
  r.w[0] = (u32)acc;
  acc >>= 32;
  acc += (u64)a.w[1] + 1u;
  r.w[1] = (u32)acc;
  acc >>= 32;
#pragma unroll
  for (int k = 2; k < 8; k++) {
    acc += a.w[k];
    r.w[k] = (u32)acc;
    acc >>= 32;
  }
  return acc ? r : a;
}

// a > b as 256-bit integers (the highest differing word decides).
__device__ __forceinline__ bool fe_gt(const Fe& a, const Fe& b) {
  bool gt = false, decided = false;
#pragma unroll
  for (int k = 7; k >= 0; k--) {
    gt = decided ? gt : a.w[k] > b.w[k];
    decided = decided || a.w[k] != b.w[k];
  }
  return gt;
}

__device__ __forceinline__ bool fe_eq(const Fe& a, const Fe& b) {
  Fe x = fe_canon(a), y = fe_canon(b);
  u32 d = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) d |= x.w[k] ^ y.w[k];
  return d == 0;
}

}  // namespace bppp
