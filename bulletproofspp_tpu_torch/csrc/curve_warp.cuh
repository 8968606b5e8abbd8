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
// No shared memory and no local memory.  The products are the ones pt_add
// and pt_dbl compute, of the same operands, so the results equal theirs
// word for word, whatever G.
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

// One round: m[j] = a[j] * b[j] for j < N, product j made by thread j of
// the group of G and broadcast to the group.
template <int N, int G>
__device__ __forceinline__ void warp_products(const Fe (&a)[N], const Fe (&b)[N], Fe (&m)[N]) {
  static_assert(N <= G && G <= 32 && (G & (G - 1)) == 0, "a group of G >= N threads");
  const int lane = threadIdx.x & (G - 1);
  const int k = lane < N ? lane : N - 1;
  const Fe p = fe_mul(fe_pick(a, k), fe_pick(b, k));
#pragma unroll
  for (int j = 0; j < N; j++) {
#pragma unroll
    for (int w = 0; w < 8; w++) m[j].w[w] = __shfl_sync(0xffffffffu, p.w[w], j, G);
  }
}

// pt_add(p, q) in two rounds of six products.
template <int G = 32>
__device__ __forceinline__ Pt pt_add_warp(const Pt& p, const Pt& q) {
  Fe m[6];
  {
    const Fe a[6] = {p.x, p.y, p.z, fe_add(p.x, p.y), fe_add(p.y, p.z), fe_add(p.x, p.z)};
    const Fe b[6] = {q.x, q.y, q.z, fe_add(q.x, q.y), fe_add(q.y, q.z), fe_add(q.x, q.z)};
    warp_products<6, G>(a, b, m);
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
  {
    const Fe a[6] = {t3, t4, y3b, t1m, z3t, t0_3};
    const Fe b[6] = {t1m, y3b, t0_3, z3t, t4, t3};
    warp_products<6, G>(a, b, m);
  }
  Pt r;
  r.x = fe_sub(m[0], m[1]);
  r.y = fe_add(m[2], m[3]);
  r.z = fe_add(m[4], m[5]);
  return r;
}

// pt_dbl(p) in two rounds of four products.
template <int G = 32>
__device__ __forceinline__ Pt pt_dbl_warp(const Pt& p) {
  Fe m[4];
  {
    const Fe a[4] = {p.y, p.y, p.z, p.x};
    const Fe b[4] = {p.y, p.z, p.z, p.y};
    warp_products<4, G>(a, b, m);
  }
  const Fe t0 = m[0], t1 = m[1], xy = m[3];
  const Fe z3 = fe_mul_small(t0, 8);
  const Fe t2 = fe_mul_small(m[2], 21);
  const Fe y3 = fe_add(t0, t2);
  const Fe t0p = fe_sub(t0, fe_mul_small(t2, 3));
  {
    const Fe a[4] = {t2, t1, t0p, t0p};
    const Fe b[4] = {z3, z3, y3, xy};
    warp_products<4, G>(a, b, m);
  }
  Pt r;
  r.y = fe_add(m[0], m[2]);
  r.z = m[1];
  r.x = fe_add(m[3], m[3]);
  return r;
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
// horner_plain (ops/kernels.py); every lane ends with the sum.
__device__ __forceinline__ Pt horner_rows_warp(const Pt* rowsum, int64_t rows) {
  Pt acc = pt_identity();
  for (int64_t r = 0; r < rows; r++) {
#pragma unroll 1
    for (int k = 0; k < 4; k++) acc = pt_dbl_warp(acc);
    acc = pt_add_warp(acc, rowsum[r]);
  }
  return acc;
}

}  // namespace bppp
