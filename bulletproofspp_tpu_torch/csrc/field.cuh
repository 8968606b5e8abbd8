// secp256k1 base field Fq = 2^256 - 2^32 - 977 as __device__ functions.
//
// Inside a kernel an element is 8 little-endian 32-bit words; every function
// returns a value < 2^256 (not necessarily < p), which is the "strict" form
// of the port's limb planes; fe_canon gives the value < p.  Products,
// additions, subtractions and the reduction run as Hopper's 32-bit carry
// chains (PTX mad.lo.cc / madc.hi.cc, add.cc / addc, sub.cc / subc), and the
// reduction folds the high half through 2^256 = 2^32 + 977 (mod p).  Each
// function's words are a fixed integer function of its inputs (its
// representative), which ops/kernels.py: field_words models and the tests
// and chip_smoke.py hold the kernels to.  Integers only.
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

// --- 32-bit carry chains.  Each helper is one PTX instruction in an asm
// volatile statement of its own (CGBN's and sppark's idiom): the carry flag
// passes from one to the next in program order, and nothing the compiler
// emits between them touches it.  A chain opens with a .cc instruction that
// takes no carry (add.cc, sub.cc, mad.lo.cc, mad.hi.cc) and closes with one
// that takes the carry without setting it (addc, subc, madc.hi);
// addc(0, 0) captures the carry out, subc(0, 0) the borrow as 0 or ~0.
#define BPPP_CC2(name, op)                                      \
  __device__ __forceinline__ u32 name(u32 a, u32 b) {           \
    u32 r;                                                      \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b)); \
    return r;                                                   \
  }
#define BPPP_CC3(name, op)                                                      \
  __device__ __forceinline__ u32 name(u32 a, u32 b, u32 c) {                    \
    u32 r;                                                                      \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));     \
    return r;                                                                   \
  }
BPPP_CC2(add_cc, "add.cc.u32")
BPPP_CC2(addc_cc, "addc.cc.u32")
BPPP_CC2(addc, "addc.u32")
BPPP_CC2(sub_cc, "sub.cc.u32")
BPPP_CC2(subc_cc, "subc.cc.u32")
BPPP_CC2(subc, "subc.u32")
BPPP_CC3(mad_lo_cc, "mad.lo.cc.u32")    // lo(a b) + c
BPPP_CC3(madc_lo_cc, "madc.lo.cc.u32")
BPPP_CC3(mad_hi_cc, "mad.hi.cc.u32")    // hi(a b) + c
BPPP_CC3(madc_hi_cc, "madc.hi.cc.u32")
BPPP_CC3(madc_hi, "madc.hi.u32")
#undef BPPP_CC2
#undef BPPP_CC3

// r + W, W = w0 + w1 2^32 + w2 2^64 < 2^68, wrapped below 2^256: where the
// sum carries out of 2^256, C = 2^32 + 977 is added to its low 256 bits.
// The wrapped sum is then < W < 2^68, so adding C reaches no word past the
// third and cannot carry again: that second chain is three words long.
__device__ __forceinline__ void fe_fold_words(Fe& r, u32 w0, u32 w1, u32 w2) {
  r.w[0] = add_cc(r.w[0], w0);
  r.w[1] = addc_cc(r.w[1], w1);
  r.w[2] = addc_cc(r.w[2], w2);
#pragma unroll
  for (int k = 3; k < 8; k++) r.w[k] = addc_cc(r.w[k], 0);
  const u32 o = addc(0, 0);  // 0 or 1
  r.w[0] = add_cc(r.w[0], o * 977u);
  r.w[1] = addc_cc(r.w[1], o);
  r.w[2] = addc(r.w[2], 0);
}

// r + c * (2^32 + 977), c = clo + chi 2^32 < 2^35, wrapped below 2^256 as
// fe_fold_words does.  c C (< 2^68) is formed first, apart from r.
__device__ __forceinline__ void fe_fold(Fe& r, u32 clo, u32 chi) {
  const u32 w1 = add_cc(__umulhi(clo, 977u) + chi * 977u, clo);  // < 2^14 + clo
  const u32 w2 = addc(chi, 0);
  fe_fold_words(r, clo * 977u, w1, w2);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  r.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) r.w[k] = addc_cc(a.w[k], b.w[k]);
  const u32 c = addc(0, 0);  // 0 or 1
  fe_fold_words(r, c * 977u, c, 0);
  return r;
}

// r - o * (2^32 + 977) with o in {0, 1}; returns the borrow out of 2^256.
__device__ __forceinline__ u32 fe_sub_c(Fe& r, u32 o) {
  r.w[0] = sub_cc(r.w[0], o * 977u);
  r.w[1] = subc_cc(r.w[1], o);
#pragma unroll
  for (int k = 2; k < 8; k++) r.w[k] = subc_cc(r.w[k], 0);
  return subc(0, 0) & 1u;
}

// a - b: on a borrow the wrapped result r = a - b + 2^256 is corrected by
// subtracting C (a - b + p = r - C); if that borrows again, r < C and the
// new wrapped value is >= 2^256 - C > C, so a second C never borrows.  That
// value's words past the second are all ones and its low 64 bits are >=
// 2^64 - C > C, so the second C is subtracted from two words.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  r.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < 8; k++) r.w[k] = subc_cc(a.w[k], b.w[k]);
  const u32 first = subc(0, 0) & 1u;
  const u32 borrow = fe_sub_c(r, first);
  r.w[0] = sub_cc(r.w[0], borrow * 977u);
  r.w[1] = subc(r.w[1], borrow);
  return r;
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) { return fe_sub(fe_zero(), a); }

// One reduction pass over a 512-bit product t[0..15] (words), T = L + H
// 2^256: S = L + 977 H + 2^32 H (= T mod p).  Returns S mod 2^256 in r and S
// >> 256 (< 2^33) as (the return value, chi).  Two chains that do not wait
// on each other, each of four 32 x 32 -> 64-bit multiply-adds on word pairs:
// L + 977 h_k 2^(32 k) for k even (pairs (k, k + 1) of L), and (977 h_k +
// h_(k-1) + 2^32 h_k) 2^(32 k) for k odd (pairs (h_(k-1), h_k) of H), which
// together hold 977 H + 2^32 H; then one chain that adds them.
__device__ __forceinline__ u32 fe_reduce_pass(const u32* t, Fe& r, u32& chi) {
  const u32* h = t + 8;
  u32 q[9];
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    r.w[k] = k ? madc_lo_cc(h[k], 977u, t[k]) : mad_lo_cc(h[k], 977u, t[k]);
    r.w[k + 1] = madc_hi_cc(h[k], 977u, t[k + 1]);
  }
  const u32 r8 = addc(0, 0);
#pragma unroll
  for (int k = 1; k < 8; k += 2) {
    q[k] = k > 1 ? madc_lo_cc(h[k], 977u, h[k - 1]) : mad_lo_cc(h[k], 977u, h[k - 1]);
    q[k + 1] = madc_hi_cc(h[k], 977u, h[k]);
  }
  const u32 q9 = addc(0, 0);
  r.w[1] = add_cc(r.w[1], q[1]);
#pragma unroll
  for (int k = 2; k < 8; k++) r.w[k] = addc_cc(r.w[k], q[k]);
  const u32 clo = addc_cc(r8, q[8]);
  chi = addc(q9, 0);
  return clo;
}

// Reduce a 512-bit product t[0..15] (words) mod p to < 2^256:
// T = L + H * 2^256 = L + H * 977 + H * 2^32 (mod p), then fe_fold.
__device__ __forceinline__ Fe fe_reduce512(const u32* t) {
  Fe r;
  u32 chi;
  const u32 clo = fe_reduce_pass(t, r, chi);
  fe_fold(r, clo, chi);
  return r;
}

// acc[i + j] += lo(a_j b) and acc[i + j + 1] += hi(a_j b) for j = j0, j0 +
// 2, ... < 8, as one carry chain of 32 x 32 -> 64-bit multiply-adds on the
// word pairs (i + j, i + j + 1), its carry into the word after the last
// pair (which no earlier row's pairs reach, so it holds at most earlier
// rows' carries and no carry goes past it); words from W on are left out
// (their carries are dropped).
template <int W>
__device__ __forceinline__ void fe_mul_row(const Fe& a, u32 b, int i, int j0, u32* acc) {
  if (j0 >= 8) return;
#pragma unroll
  for (int j = j0; j < 8; j += 2) {
    const int k = i + j;
    if (k < W) acc[k] = j > j0 ? madc_lo_cc(a.w[j], b, acc[k]) : mad_lo_cc(a.w[j], b, acc[k]);
    if (k + 1 < W) acc[k + 1] = madc_hi_cc(a.w[j], b, acc[k + 1]);
  }
  const int top = i + j0 + (7 - j0) / 2 * 2 + 2;
  if (top < W) acc[top] = addc(acc[top], 0);
}

// The low W words (W <= 16) of the product a * b into t[0..W-1].  Each word
// product a_j b_i is one 32 x 32 -> 64-bit multiply-add into the word pair
// (i + j, i + j + 1), and the products of one row i whose pairs start at an
// even word do not overlap, nor do those that start at an odd word: each
// row adds the first into one accumulator, whose pairs are always (2m, 2m
// + 1), and the second into another, whose pairs are (2m + 1, 2m + 2): two
// carry chains of four multiply-adds that do not wait on each other, on
// pairs that stay in place from row to row.  The two accumulators are
// added at the end; neither reaches 2^512 (each is part of the product).
// Chains are cut at word W: the low words are exact mod 2^(32 W).
template <int W>
__device__ __forceinline__ void fe_mul_words(const Fe& a, const Fe& b, u32* t) {
  u32 e[17], o[17];  // pairs from even words, pairs from odd words
#pragma unroll
  for (int k = 0; k < 17; k++) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    fe_mul_row<W>(a, b.w[i], i, i & 1, e);
    fe_mul_row<W>(a, b.w[i], i, 1 - (i & 1), o);
  }
  t[0] = e[0];
  if (W > 1) t[1] = add_cc(e[1], o[1]);
#pragma unroll
  for (int k = 2; k < W; k++) t[k] = k + 1 < W ? addc_cc(e[k], o[k]) : addc(e[k], o[k]);
}

// The 512-bit product a * b into t[0..15] (words).
__device__ __forceinline__ void fe_mul_wide(const Fe& a, const Fe& b, u32* t) {
  fe_mul_words<16>(a, b, t);
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  u32 t[16];
  fe_mul_wide(a, b, t);
  return fe_reduce512(t);
}

// a^2 mod p, strict, for decompress's square-root chain: 36 word products
// against fe_mul's 64.  The 28 cross products a_i a_j (i < j) go into two
// accumulators by the parity of their word i + j, as fe_mul_words does
// (rows of at most four multiply-adds on aligned pairs); their sum is
// doubled by a one-bit funnel shift, and the 8 squares a_i^2, on the pairs
// (2i, 2i + 1), are added in one chain; then fe_reduce512.  Equal to
// fe_mul(a, a) mod p (not necessarily the same representative).
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  u32 e[17], o[17], t[16];
#pragma unroll
  for (int k = 0; k < 17; k++) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {
    fe_mul_row<16>(a, a.w[i], i, i + 2, e);
    fe_mul_row<16>(a, a.w[i], i, i + 1, o);
  }
  u32 c = add_cc(e[1], o[1]);  // the cross products' sum: word 0 is 0
  t[0] = 0;
  t[1] = c << 1;
#pragma unroll
  for (int k = 2; k < 16; k++) {
    const u32 next = k < 15 ? addc_cc(e[k], o[k]) : addc(e[k], o[k]);
    t[k] = __funnelshift_l(c, next, 1);  // twice the sum, word k
    c = next;
  }
  t[0] = mad_lo_cc(a.w[0], a.w[0], t[0]);
  t[1] = madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < 8; i++) {
    t[2 * i] = madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = i < 7 ? madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]) : madc_hi(a.w[i], a.w[i], t[15]);
  }
  return fe_reduce512(t);
}

// a * k mod p, strict (k < 2^32 - 1; the curve's 3, 8 and 21).  The word
// products a_i k of even i fill the word pairs (i, i + 1) without
// overlapping, and so do those of odd i; the two sums are added in one
// carry chain, and its carry out of 2^256 (< k) is folded.
__device__ __forceinline__ Fe fe_mul_small(const Fe& a, u32 k) {
  u32 e[8], o[9];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const u64 pe = (u64)a.w[i] * k, po = (u64)a.w[i + 1] * k;
    e[i] = (u32)pe;
    e[i + 1] = (u32)(pe >> 32);
    o[i + 1] = (u32)po;
    o[i + 2] = (u32)(po >> 32);
  }
  Fe r;
  r.w[0] = e[0];
  r.w[1] = add_cc(e[1], o[1]);
#pragma unroll
  for (int i = 2; i < 8; i++) r.w[i] = addc_cc(e[i], o[i]);
  const u32 c = addc(o[8], 0);
  fe_fold(r, c, 0);
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
  r.w[0] = add_cc(a.w[0], 977u);
  r.w[1] = addc_cc(a.w[1], 1u);
#pragma unroll
  for (int k = 2; k < 8; k++) r.w[k] = addc_cc(a.w[k], 0);
  return addc(0, 0) ? r : a;
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
