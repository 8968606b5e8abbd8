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
