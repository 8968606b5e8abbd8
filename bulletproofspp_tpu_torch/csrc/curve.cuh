// Complete projective addition and doubling on secp256k1 (a = 0, b3 = 21):
// Renes-Costello-Batina 2015, Algorithms 7 and 9, the algebra of
// bulletproofspp_tpu/ops/pallas_field.py:_padd_body / _pdbl_body and of the
// port's ops/curve.py.  Branchless and valid for every input on the curve,
// the identity (0:1:0) included.
#pragma once

#include "field.cuh"

namespace bppp {

struct Pt {
  Fe x, y, z;
};

// beta, the cube root of unity mod p of the GLV endomorphism (core/ec.py:
// BETA), as 8 little-endian 32-bit words: phi(x, y, z) = (beta x, y, z)
// (lanes.cu: endo_kernel and assemble_kernel, kernels.cu:
// complete_square_kernel, all fe_mul(x, fe_beta()))
__device__ __forceinline__ Fe fe_beta() {
  const u32 w[8] = {0x719501eeu, 0xc1396c28u, 0x12f58995u, 0x9cf04975u,
                    0xac3434e9u, 0x6e64479eu, 0x657c0710u, 0x7ae96a2bu};
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = w[k];
  return r;
}

__device__ __forceinline__ Pt pt_identity() {
  Pt r;
  r.x = fe_zero();
  r.y = fe_one();
  r.z = fe_zero();
  return r;
}

__device__ __forceinline__ Pt pt_load(const int64_t* x, const int64_t* y, const int64_t* z,
                                      int64_t stride, int64_t j) {
  Pt r;
  r.x = fe_load(x, stride, j);
  r.y = fe_load(y, stride, j);
  r.z = fe_load(z, stride, j);
  return r;
}

__device__ __forceinline__ void pt_store(int64_t* x, int64_t* y, int64_t* z, int64_t stride,
                                         int64_t j, const Pt& p) {
  fe_store(x, stride, j, p.x);
  fe_store(y, stride, j, p.y);
  fe_store(z, stride, j, p.z);
}

// Entry |d| (and sign s for Y) of lane j from flat multiple tables: entry e,
// limb i, lane j at (16 e + i) * n + j; tx and tz hold entries 0..8, ty2
// also their negated Y at entries 9..17.
__device__ __forceinline__ Pt table_entry(const int64_t* tx, const int64_t* ty2, const int64_t* tz,
                                          int64_t n, int64_t j, int64_t d, int64_t s) {
  Pt e;
  e.x = fe_load(tx + 16 * d * n, n, j);
  e.y = fe_load(ty2 + 16 * (d + 9 * s) * n, n, j);
  e.z = fe_load(tz + 16 * d * n, n, j);
  return e;
}

// Selected point j = (b rows + r) L + l of an MSM route: the entry that
// digit (b, r, l) of the (B, rows, L) uint8 planes picks (X and Z |d|, Y |d|
// + 9 s) from lane b L + l of flat tables of n = B L lanes.  select_small
// stores these points; reduce_lanes, reduce_block and tail_rows read them
// here in their first level instead.  A digit past 8 reads outside the
// tables (not checked: the recodings make none).
__device__ __forceinline__ Pt selected_point(const int64_t* tx, const int64_t* ty2,
                                             const int64_t* tz, const uint8_t* absd,
                                             const uint8_t* sgn, int64_t n, int64_t rows,
                                             int64_t L, int64_t j) {
  return table_entry(tx, ty2, tz, n, (j / (rows * L)) * L + j % L, absd[j], sgn[j]);
}

__device__ __noinline__ Pt pt_add(const Pt& p, const Pt& q) {
  Fe t0 = fe_mul(p.x, q.x);
  Fe t1 = fe_mul(p.y, q.y);
  Fe t2 = fe_mul(p.z, q.z);
  Fe t3 = fe_sub(fe_mul(fe_add(p.x, p.y), fe_add(q.x, q.y)), fe_add(t0, t1));
  Fe t4 = fe_sub(fe_mul(fe_add(p.y, p.z), fe_add(q.y, q.z)), fe_add(t1, t2));
  Fe t5 = fe_sub(fe_mul(fe_add(p.x, p.z), fe_add(q.x, q.z)), fe_add(t0, t2));
  Fe t0_3 = fe_mul_small(t0, 3);
  Fe t2b = fe_mul_small(t2, 21);
  Fe z3t = fe_add(t1, t2b);
  Fe t1m = fe_sub(t1, t2b);
  Fe y3b = fe_mul_small(t5, 21);
  Pt r;
  r.x = fe_sub(fe_mul(t3, t1m), fe_mul(t4, y3b));
  r.y = fe_add(fe_mul(y3b, t0_3), fe_mul(t1m, z3t));
  r.z = fe_add(fe_mul(z3t, t4), fe_mul(t0_3, t3));
  return r;
}

// Sum the N points load(j + k s), k < N, in the Pallas kernels' halving
// order (first half plus second half, until one is left): the pairs m and
// m + N/2 first, then m and m + N/4, ...  Depth first, so at most
// log2 N + 1 partial sums are live at a time.
template <int N, class Load>
__device__ __forceinline__ Pt halving_tree(const Load& load, int j, int s) {
  if constexpr (N == 1) {
    return load(j);
  } else {
    Pt a = halving_tree<N / 2>(load, j, 2 * s);
    Pt b = halving_tree<N / 2>(load, j + s, 2 * s);
    return pt_add(a, b);
  }
}

__device__ __noinline__ Pt pt_dbl(const Pt& p) {
  Fe t0 = fe_mul(p.y, p.y);
  Fe z3 = fe_mul_small(t0, 8);
  Fe t1 = fe_mul(p.y, p.z);
  Fe t2 = fe_mul_small(fe_mul(p.z, p.z), 21);
  Fe x3 = fe_mul(t2, z3);
  Fe y3 = fe_add(t0, t2);
  Pt r;
  r.z = fe_mul(t1, z3);
  t0 = fe_sub(t0, fe_mul_small(t2, 3));
  r.y = fe_add(x3, fe_mul(t0, y3));
  Fe xy2 = fe_mul(t0, fe_mul(p.x, p.y));
  r.x = fe_add(xy2, xy2);
  return r;
}

}  // namespace bppp
