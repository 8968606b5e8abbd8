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

// libsecp256k1's addition chain for the square root (decompress.cu:
// fe_sqrt_candidate) begins with the ladder below: xk = a^(2^k - 1), each
// step squaring the last result s times and multiplying it by xk, (s, k) in
// the comments (bounds.py: SQRT_CHAIN).  The chain then takes its products
// from x2, x22 and x223.
struct FeLadder {
  Fe x2, x22, x223;
};

__device__ __forceinline__ FeLadder fe_ladder(const Fe& a) {
  FeLadder l;
  l.x2 = fe_mul(fe_sqr(a), a);                        // (1, 1)
  const Fe x3 = fe_mul(fe_sqr(l.x2), a);              // (1, 1)
  const Fe x6 = fe_mul(fe_sqr_n(x3, 3), x3);          // (3, 3)
  const Fe x9 = fe_mul(fe_sqr_n(x6, 3), x3);          // (3, 3)
  const Fe x11 = fe_mul(fe_sqr_n(x9, 2), l.x2);       // (2, 2)
  l.x22 = fe_mul(fe_sqr_n(x11, 11), x11);             // (11, 11)
  const Fe x44 = fe_mul(fe_sqr_n(l.x22, 22), l.x22);  // (22, 22)
  const Fe x88 = fe_mul(fe_sqr_n(x44, 44), x44);      // (44, 44)
  const Fe x176 = fe_mul(fe_sqr_n(x88, 88), x88);     // (88, 88)
  const Fe x220 = fe_mul(fe_sqr_n(x176, 44), x44);    // (44, 44)
  l.x223 = fe_mul(fe_sqr_n(x220, 3), x3);             // (3, 3)
  return l;
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

// --- a^-1 mod p by safegcd divsteps (Bernstein and Yang, "Fast
// constant-time gcd computation and modular inversion", 2019), as
// libsecp256k1's secp256k1_modinv32 runs them: its constant-time schedule,
// so every lane of a warp takes the same steps.  Signed 30-bit limbs (9 of
// them hold 256 bits); f = p and g = a, and beside them d = 0 and e = 1,
// with d a = f and e a = g (mod p) throughout.  Each batch runs 30 divsteps
// on the low words of f and g alone (fe_divsteps_30: adds, logic and shifts,
// no multiply), which yields a 2x2 matrix t of integers of at most 30 bits
// with t (f, g) = 2^30 (f', g'); the batch then applies it to (f, g) and,
// mod p, to (d, e) (30 x 9 limb products each: fe_update_fg_30,
// fe_update_de_30).  590 divsteps take any 256-bit g to 0 and f to +-1, so
// 20 batches of 30 (bounds.py: DIVSTEP_BATCHES, DIVSTEPS_A_BATCH) leave
// d = +-a^-1; a = 0 leaves d = 0.  The matrix updates and the last
// normalization are libsecp256k1's code over int32/int64, in its order;
// tests/test_torch_affine.py transcribes this schedule in Python, limb for
// limb, and holds it against pow(a, p - 2, p).
constexpr int kDivstepBatches = 20;  // (20 batches of 30 divsteps)
constexpr int kDivstepsABatch = 30;
constexpr int32_t kM30 = (int32_t)(0xffffffffu >> 2);
constexpr u32 kPInv30 = 0x2ddacacfu;  // p^-1 mod 2^30

struct S30 {
  int32_t v[9];  // limb i at 2^(30 i); limbs 0-7 in [0, 2^30), limb 8 signed
};

struct Trans30 {
  int32_t u, v, q, r;
};

// p in limbs: -977 - 4 * 2^30 + 2^16 * 2^240
__device__ __forceinline__ int32_t p30(int i) {
  return i == 0 ? -977 : i == 1 ? -4 : i == 8 ? 65536 : 0;
}

// Canonical words -> limbs of 30 bits (the top one of 16): limb i is bits
// 30 i to 30 i + 29, from word 30 i / 32 and the next.
__device__ __forceinline__ S30 s30_from_fe(const Fe& a) {
  S30 r;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int k = 30 * i / 32, s = 30 * i % 32;
    u32 x = a.w[k] >> s;
    if (s > 2 && k + 1 < 8) x |= a.w[k + 1] << (32 - s);
    r.v[i] = (int32_t)(x & (u32)kM30);
  }
  return r;
}

// Limbs in [0, 2^30) (the top one < 2^16) -> words: word k is bits 32 k to
// 32 k + 31, from limb 32 k / 30 and the next.
__device__ __forceinline__ Fe fe_from_s30(const S30& a) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int i = 32 * k / 30, s = 32 * k % 30;
    r.w[k] = ((u32)a.v[i] >> s) | ((u32)a.v[i + 1] << (30 - s));
  }
  return r;
}

// 30 divsteps on the low words f0 (odd) and g0: the new zeta (= -(delta +
// 1/2)) and the matrix t, with t (f, g) = 2^30 (f', g').  u, v, q and r lie
// in [-2^30, 2^30], kept as words mod 2^32 (secp256k1_modinv32_divsteps_30).
__device__ __forceinline__ int32_t fe_divsteps_30(int32_t zeta, u32 f0, u32 g0, Trans30& t) {
  u32 u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
#pragma unroll
  for (int i = 0; i < kDivstepsABatch; i++) {
    const u32 c1 = (u32)(zeta >> 31);  // zeta < 0
    const u32 c2 = 0u - (g & 1u);      // g odd
    const u32 x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    const u32 c3 = c1 & c2;  // both: swap, zeta -> -zeta - 2
    zeta = (int32_t)(((u32)zeta ^ c3) - 1u);
    f += g & c3;
    u += q & c3;
    v += r & c3;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t.u = (int32_t)u;
  t.v = (int32_t)v;
  t.q = (int32_t)q;
  t.r = (int32_t)r;
  return zeta;
}

// (d, e) <- t (d, e) / 2^30 mod p, d and e kept in (-2p, p): the multiples
// md and me of p that make the low 30 bits 0 are chosen from the low limbs
// (secp256k1_modinv32_update_de_30).
__device__ __forceinline__ void fe_update_de_30(S30& d, S30& e, const Trans30& t) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se), me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((kPInv30 * (u32)cd + (u32)md) & (u32)kM30);
  me -= (int32_t)((kPInv30 * (u32)ce + (u32)me) & (u32)kM30);
  cd += (int64_t)p30(0) * md;
  ce += (int64_t)p30(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i];
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i];
    if (p30(i)) {  // limbs 1 and 8 (0 at 2-7)
      cd += (int64_t)p30(i) * md;
      ce += (int64_t)p30(i) * me;
    }
    d.v[i - 1] = (int32_t)cd & kM30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & kM30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30, exact (secp256k1_modinv32_update_fg_30).
__device__ __forceinline__ void fe_update_fg_30(S30& f, S30& g, const Trans30& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)cf & kM30;
    cf >>= 30;
    g.v[i - 1] = (int32_t)cg & kM30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// r in (-2p, p) -> [0, p), negated first where `sign` < 0
// (secp256k1_modinv32_normalize_30).
__device__ __forceinline__ void s30_normalize(S30& r, int32_t sign) {
  int32_t add = r.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) r.v[i] += p30(i) & add;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) r.v[i] = (r.v[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= kM30;
  }
  add = r.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) r.v[i] += p30(i) & add;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    r.v[i + 1] += r.v[i] >> 30;
    r.v[i] &= kM30;
  }
}

// a^-1 mod p, canonical; 0 (and p) -> 0.  The strict input is made
// canonical first.
__device__ __forceinline__ Fe fe_inv_divsteps(const Fe& a) {
  S30 d, e, f, g = s30_from_fe(fe_canon(a));
#pragma unroll
  for (int i = 0; i < 9; i++) {
    d.v[i] = 0;
    e.v[i] = i == 0;
    f.v[i] = p30(i);
  }
  int32_t zeta = -1;  // delta = 1/2
#pragma unroll 1
  for (int b = 0; b < kDivstepBatches; b++) {
    Trans30 t;
    zeta = fe_divsteps_30(zeta, (u32)f.v[0], (u32)g.v[0], t);
    fe_update_de_30(d, e, t);
    fe_update_fg_30(f, g, t);
  }
  s30_normalize(d, f.v[8]);  // f = +-1: d a = f
  return fe_from_s30(d);
}

}  // namespace bppp
