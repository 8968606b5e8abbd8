// Complete addition and doubling computed by a group of G threads of one
// warp together (G = 32: the whole warp), for chains of dependent point
// operations (Horner, fold, the multiples of a table).
//
// One thread running pt_add issues its 12 field products one after another
// (12 x ~250 instructions): a single warp of dependent work is bound by
// its own issue rate and latency, not by the card.  The RCB formulas of
// curve.cuh split into rounds of independent products:
//   addition: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
//             (X1+Z1)(X2+Z2); then the six products of the outputs;
//   doubling: YY, YZ, ZZ, XY; then t2 z3, t1 z3, t0' y3, t0' XY.
// Every lane holds every operand in registers and runs the cheap steps
// (fe_add, fe_sub, fe_mul_small) redundantly.  In a round lane k picks
// operand pair k by a chain of selects (lanes past the round's count pick
// the last pair) and multiplies it, so the warp issues one product per
// round and never diverges; __shfl_sync then gives every lane of the group
// every product.  A narrower group (G = 8 holds the addition's 6 products)
// lets one warp carry 32 / G independent chains for the same instructions
// a round: __shfl_sync's width keeps each group's broadcasts inside it.
// Every thread of the warp must make the call (the shuffles name all 32).
// No shared memory and no local memory.  fold_rows' chain (kernels.cu),
// on groups of 16 or 32 threads, and Horner's on the whole warp, where a
// product a thread leaves threads idle, spread each product over two threads (S = 2, fe_mul_split: half
// the word products each, the halves added on one of them), broadcast by
// the same shuffles.  The products are the ones pt_add and pt_dbl compute,
// of the same operands, so the results equal theirs word for word,
// whatever G and S.
#pragma once

#include "curve.cuh"

namespace bppp {

// v[k] for a lane-dependent k, in registers (an indexed register array
// would go to local memory).
template <int N>
__device__ __forceinline__ Fe fe_pick(const Fe (&v)[N], int k) {
  Fe r = v[0];
#pragma unroll
  for (int j = 1; j < N; j++) {
#pragma unroll
    for (int w = 0; w < 8; w++) r.w[w] = k == j ? v[j].w[w] : r.w[w];
  }
  return r;
}

// The parts of a round that tools.cu's round phases time on one warp (the
// pick of a thread's operand pair, with the sums the addition's first round
// picks from; its product; the split product's combination; the broadcast;
// the cheap steps between rounds), and the hook every other caller's rounds
// take: NoParts, which compiles away.
enum RoundPart { kPartForm, kPartProduct, kPartCombine, kPartBroadcast, kPartSteps, kRoundParts };

struct NoParts {
  template <class... T>
  __device__ __forceinline__ void mark(int, const T&...) {}
};

// a * b4 for 4 words b4 = b_(4h..4h+3) of b: 12 words, fe_mul_words' two
// accumulators over 4 rows.  No carry leaves word 11: every partial sum of
// either accumulator is part of a * b4 < 2^384.
__device__ __forceinline__ void fe_mul_half(const Fe& a, const u32 (&b4)[4], u32 (&t)[12]) {
  u32 e[12], o[12];  // pairs from even words, pairs from odd words
#pragma unroll
  for (int k = 0; k < 12; k++) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < 4; i++) {
    fe_mul_row<12>(a, b4[i], i, i & 1, e);
    fe_mul_row<12>(a, b4[i], i, 1 - (i & 1), o);
  }
  t[0] = e[0];
  t[1] = add_cc(e[1], o[1]);
#pragma unroll
  for (int k = 2; k < 12; k++) t[k] = k + 1 < 12 ? addc_cc(e[k], o[k]) : addc(e[k], o[k]);
}

// fe_mul(x, y) made by the two threads 2i and 2i + 1 of a group of G
// together (both call it with the same pair): thread 2i + h forms x
// times y's words 4h..4h + 3 (fe_mul_half: 32 word products, half of
// fe_mul's), the odd one hands its 12 words to the even one by shuffles,
// which adds them at word 4 (a 12-word carry chain) into the 512-bit
// product fe_mul_wide gives and reduces it with fe_reduce512: fe_mul's
// words on the even thread (ops/kernels.py: field_words' "mul_split"
// models them).  The odd thread's result is not the product.
template <int G, class Parts>
__device__ __forceinline__ Fe fe_mul_split(const Fe& x, const Fe& y, Parts&& parts) {
  const bool h = threadIdx.x & 1;
  u32 y4[4];
#pragma unroll
  for (int i = 0; i < 4; i++) y4[i] = h ? y.w[4 + i] : y.w[i];
  u32 t[12], o[12], w[16];
  fe_mul_half(x, y4, t);
  parts.mark(kPartProduct, t);
#pragma unroll
  for (int k = 0; k < 12; k++) o[k] = __shfl_xor_sync(0xffffffffu, t[k], 1, G);
#pragma unroll
  for (int k = 0; k < 4; k++) w[k] = t[k];
  w[4] = add_cc(t[4], o[0]);
#pragma unroll
  for (int k = 5; k < 12; k++) w[k] = addc_cc(t[k], o[k - 4]);
#pragma unroll
  for (int k = 12; k < 15; k++) w[k] = addc_cc(o[k - 4], 0);
  w[15] = addc(o[11], 0);
  parts.mark(kPartCombine, w);
  return fe_reduce512(w);
}

// One round: m[j] = a[j] * b[j] for j < N, product j made by threads S j ..
// S j + S - 1 of the group of G (S = 1: fe_mul on thread j; S = 2:
// fe_mul_split; threads past S N repeat the last product) and broadcast to
// the group.  Every thread of the warp must make the call.
template <int N, int G, int S, class Parts>
__device__ __forceinline__ void warp_products(const Fe (&a)[N], const Fe (&b)[N], Fe (&m)[N],
                                              Parts&& parts) {
  static_assert(S == 1 || S == 2, "a product on one or two threads");
  static_assert(S * N <= G && G <= 32 && (G & (G - 1)) == 0, "a group of G >= S N threads");
  const int r = (threadIdx.x & (G - 1)) / S;
  const int k = r < N ? r : N - 1;
  const Fe x = fe_pick(a, k), y = fe_pick(b, k);
  parts.mark(kPartForm, x, y);
  Fe p;
  if constexpr (S == 2) {
    p = fe_mul_split<G>(x, y, parts);
  } else {
    p = fe_mul(x, y);
  }
  parts.mark(kPartProduct, p);
#pragma unroll
  for (int j = 0; j < N; j++) {
#pragma unroll
    for (int w = 0; w < 8; w++) m[j].w[w] = __shfl_sync(0xffffffffu, p.w[w], S * j, G);
  }
  parts.mark(kPartBroadcast, m);
}

// pt_add(p, q) in two rounds of six products, each on S threads (S = 2
// needs G >= 16).
template <int G = 32, int S = 1, class Parts = NoParts>
__device__ __forceinline__ Pt pt_add_warp(const Pt& p, const Pt& q, Parts&& parts = Parts()) {
  Fe m[6];
  {
    const Fe a[6] = {p.x, p.y, p.z, fe_add(p.x, p.y), fe_add(p.y, p.z), fe_add(p.x, p.z)};
    const Fe b[6] = {q.x, q.y, q.z, fe_add(q.x, q.y), fe_add(q.y, q.z), fe_add(q.x, q.z)};
    warp_products<6, G, S>(a, b, m, parts);
  }
  const Fe t0 = m[0], t1 = m[1], t2 = m[2];
  const Fe t3 = fe_sub(m[3], fe_add(t0, t1));
  const Fe t4 = fe_sub(m[4], fe_add(t1, t2));
  const Fe t5 = fe_sub(m[5], fe_add(t0, t2));
  const Fe t0_3 = fe_mul_small(t0, 3);
  const Fe t2b = fe_mul_small(t2, 21);
  const Fe z3t = fe_add(t1, t2b);
  const Fe t1m = fe_sub(t1, t2b);
  const Fe y3b = fe_mul_small(t5, 21);
  parts.mark(kPartSteps, t3, t4, y3b, t1m, z3t, t0_3);
  {
    const Fe a[6] = {t3, t4, y3b, t1m, z3t, t0_3};
    const Fe b[6] = {t1m, y3b, t0_3, z3t, t4, t3};
    warp_products<6, G, S>(a, b, m, parts);
  }
  Pt r;
  r.x = fe_sub(m[0], m[1]);
  r.y = fe_add(m[2], m[3]);
  r.z = fe_add(m[4], m[5]);
  parts.mark(kPartSteps, r);
  return r;
}

// pt_dbl(p) in two rounds of four products, each on S threads.
template <int G = 32, int S = 1, class Parts = NoParts>
__device__ __forceinline__ Pt pt_dbl_warp(const Pt& p, Parts&& parts = Parts()) {
  Fe m[4];
  {
    const Fe a[4] = {p.y, p.y, p.z, p.x};
    const Fe b[4] = {p.y, p.z, p.z, p.y};
    warp_products<4, G, S>(a, b, m, parts);
  }
  const Fe t0 = m[0], t1 = m[1], xy = m[3];
  const Fe z3 = fe_mul_small(t0, 8);
  const Fe t2 = fe_mul_small(m[2], 21);
  const Fe y3 = fe_add(t0, t2);
  const Fe t0p = fe_sub(t0, fe_mul_small(t2, 3));
  parts.mark(kPartSteps, z3, t2, y3, t0p);
  {
    const Fe a[4] = {t2, t1, t0p, t0p};
    const Fe b[4] = {z3, z3, y3, xy};
    warp_products<4, G, S>(a, b, m, parts);
  }
  Pt r;
  r.y = fe_add(m[0], m[2]);
  r.z = m[1];
  r.x = fe_add(m[3], m[3]);
  parts.mark(kPartSteps, r);
  return r;
}

// a where c, else b, word by word: a ternary on the structs takes their
// addresses and keeps them in local memory (a 384-byte stack frame in
// complete_square_kernel<16>, and its chain 7% slower a round).
__device__ __forceinline__ Pt pt_select(bool c, const Pt& a, const Pt& b) {
  Pt r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    r.x.w[k] = c ? a.x.w[k] : b.x.w[k];
    r.y.w[k] = c ? a.y.w[k] : b.y.w[k];
    r.z.w[k] = c ? a.z.w[k] : b.z.w[k];
  }
  return r;
}

// The threads each product of pt_add_pair's additions runs on: G / 2 = 8
// threads hold an addition's 6 products one a thread, 16 two a product.
template <int G>
constexpr int kPairSplit = G >= 32 ? 2 : 1;

// Two independent additions at once on a group of G >= 16 threads (the
// paired addition of kernels.cu: fold_rows): the group's first half (threads
// 0 .. G / 2 - 1 of it) makes a0 + b0 and its second half a1 + b1, each on
// G / 2 threads (pt_add_warp<G / 2>: the shuffles stay inside the half),
// then each half hands its sum to the other by shuffles, so every thread
// of the group ends with both: r0 = a0 + b0, r1 = a1 + b1.  Both halves
// issue the same instructions; each passes the operands of its own sum and
// may pass anything for the other's.
template <int G, class Parts = NoParts>
__device__ __forceinline__ void pt_add_pair(const Pt& a0, const Pt& b0, const Pt& a1,
                                            const Pt& b1, Pt& r0, Pt& r1,
                                            Parts&& parts = Parts()) {
  static_assert(G >= 16 && G <= 32, "two halves of at least 8 threads");
  const bool h = (threadIdx.x / (G / 2)) & 1;
  const Pt v = pt_add_warp<G / 2, kPairSplit<G>>(pt_select(h, a1, a0), pt_select(h, b1, b0), parts);
  Pt o;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    o.x.w[k] = __shfl_xor_sync(0xffffffffu, v.x.w[k], G / 2, G);
    o.y.w[k] = __shfl_xor_sync(0xffffffffu, v.y.w[k], G / 2, G);
    o.z.w[k] = __shfl_xor_sync(0xffffffffu, v.z.w[k], G / 2, G);
  }
  parts.mark(kPartBroadcast, o);
  r0 = pt_select(h, o, v);
  r1 = pt_select(h, v, o);
}

// Thread r of a group of G stores its share of the NF elements v at lane
// j: words i = r, r + G, ... of the 8 NF (word i % 8 of element i / 8), as
// limbs 2 (i % 8) and 2 (i % 8) + 1 of plane dst[i / 8] (fe_store's
// layout).  Neighbouring groups hold neighbouring lanes, so one store
// instruction of a warp writes 32 / G neighbouring lanes of each of G limb
// rows: at G = 8 one whole 32-byte sector a row.  The element and the word
// are picked by selects, not by indexing (local memory).
template <int G, int NF>
__device__ __forceinline__ void fe_store_group(int64_t* const (&dst)[NF], const Fe (&v)[NF],
                                               int64_t stride, int64_t j) {
  const int r = threadIdx.x & (G - 1);
#pragma unroll
  for (int i0 = 0; i0 < 8 * NF; i0 += G) {
    const int i = i0 + r;
    if (i < 8 * NF) {
      const int f = i / 8, w = i % 8;
      const Fe a = fe_pick(v, f);
      u32 word = a.w[0];
#pragma unroll
      for (int k = 1; k < 8; k++) word = w == k ? a.w[k] : word;
      int64_t* p = dst[0];
#pragma unroll
      for (int k = 1; k < NF; k++) p = f == k ? dst[k] : p;
      p[(2 * w) * stride + j] = (int64_t)(word & 0xffffu);
      p[(2 * w + 1) * stride + j] = (int64_t)(word >> 16);
    }
  }
}

// Horner over row sums, MSB row first (acc = 16 acc + row r), the order of
// horner_plain (ops/kernels.py), on the whole warp, each product of a round
// on S threads: 8 S threads in a doubling's round, 12 S in an addition's
// (kernels.cu: kHornerSplit); every lane ends with the sum.
template <int S>
__device__ __forceinline__ Pt horner_rows_warp(const Pt* rowsum, int64_t rows) {
  Pt acc = pt_identity();
  for (int64_t r = 0; r < rows; r++) {
#pragma unroll 1
    for (int k = 0; k < 4; k++) acc = pt_dbl_warp<32, S>(acc);
    acc = pt_add_warp<32, S>(acc, rowsum[r]);
  }
  return acc;
}

}  // namespace bppp
