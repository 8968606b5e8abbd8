// Native host-side scalar pipeline for the TPU MSM engine.
//
// The reference implements its scalar machinery at the native level
// (GHC unboxed primops + GMP, reference:
// src/Data/Field/Galois/FastPrime/Internal.hs; GLV decomposition,
// reference: src/Data/Field/Galois/FastPrime.hs:186-205).  This library is
// the equivalent layer for the TPU build: it turns 256-bit scalars into
// the fixed-shape signed-digit arrays the device kernels consume
// (ops/glv.py documents the math; this is the production path, the Python
// implementation is the fallback and ground truth).
//
// C ABI only; loaded via ctypes (bulletproofspp_tpu/native.py).
//
// Scalar wire format: 4 x uint64 little-endian limbs (value < 2^256).
// Digit output layout: row-major (ROWS, 2n) uint32 arrays, column 2i for
// the k1 half of scalar i, column 2i+1 for the k2 half — exactly the lane
// order of ops.engine.JaxEngine.msm.

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

static const int ROWS = 33;

// ---------------------------------------------------------------------------
// small fixed-size bigint helpers (little-endian u64 limbs)
// ---------------------------------------------------------------------------

// r[0..na+nb) = a[0..na) * b[0..nb)
static void mul_nn(const u64* a, int na, const u64* b, int nb, u64* r) {
    for (int i = 0; i < na + nb; i++) r[i] = 0;
    for (int i = 0; i < na; i++) {
        u128 carry = 0;
        for (int j = 0; j < nb; j++) {
            u128 t = (u128)a[i] * b[j] + r[i + j] + carry;
            r[i + j] = (u64)t;
            carry = t >> 64;
        }
        r[i + nb] = (u64)carry;
    }
}

// a += b (both n limbs); returns carry
static u64 add_n(u64* a, const u64* b, int n) {
    u128 c = 0;
    for (int i = 0; i < n; i++) {
        u128 t = (u128)a[i] + b[i] + c;
        a[i] = (u64)t;
        c = t >> 64;
    }
    return (u64)c;
}

// a -= b (both n limbs); returns borrow
static u64 sub_n(u64* a, const u64* b, int n) {
    u128 borrow = 0;
    for (int i = 0; i < n; i++) {
        u128 t = (u128)a[i] - b[i] - borrow;
        a[i] = (u64)t;
        borrow = (t >> 64) ? 1 : 0;
    }
    return (u64)borrow;
}

static int cmp_n(const u64* a, const u64* b, int n) {
    for (int i = n - 1; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] < b[i] ? -1 : 1;
    }
    return 0;
}

static bool is_zero_n(const u64* a, int n) {
    for (int i = 0; i < n; i++)
        if (a[i]) return false;
    return true;
}

// signed value: sign in {+1,-1} with magnitude limbs
struct Signed {
    int sign;  // +1 / -1 (zero: sign=+1, mag=0)
    u64 mag[6];
    int n;  // limbs used
};

static void sgn_set(Signed& s, int sign, const u64* mag, int n) {
    s.sign = sign;
    s.n = n;
    for (int i = 0; i < 6; i++) s.mag[i] = i < n ? mag[i] : 0;
}

// s += t  (signed, in place; capacity 6 limbs)
static void sgn_add(Signed& s, const Signed& t) {
    if (s.sign == t.sign) {
        u64 c = add_n(s.mag, t.mag, 6);
        (void)c;  // magnitudes stay < 2^384 by construction
    } else {
        if (cmp_n(s.mag, t.mag, 6) >= 0) {
            sub_n(s.mag, t.mag, 6);
        } else {
            u64 tmp[6];
            std::memcpy(tmp, t.mag, sizeof tmp);
            sub_n(tmp, s.mag, 6);
            std::memcpy(s.mag, tmp, sizeof tmp);
            s.sign = t.sign;
        }
    }
    if (is_zero_n(s.mag, 6)) s.sign = 1;
}

// ---------------------------------------------------------------------------
// GLV parameters (filled by glv_init from Python; no hard-coded lattice)
// ---------------------------------------------------------------------------

struct GlvParams {
    Signed a1, b1, a2, b2;  // lattice vectors v1=(a1,b1), v2=(a2,b2)
    u64 g1[5];              // round(2^384 * b2 / det)   (det > 0)
    u64 g2[5];              // round(2^384 * -b1 / det)
    int g1_sign, g2_sign;
};

static GlvParams G;
static int g_inited = 0;

// params: packed as 4 signed vectors (sign as int64, 3 u64 limbs each) for
// a1,b1,a2,b2, then g1_sign,i64 + 5 u64, g2_sign,i64 + 5 u64.
extern "C" void glv_init(const int64_t* signs, const u64* mags,
                         int64_t g1_sign, const u64* g1,
                         int64_t g2_sign, const u64* g2) {
    Signed* dst[4] = {&G.a1, &G.b1, &G.a2, &G.b2};
    for (int i = 0; i < 4; i++) sgn_set(*dst[i], (int)signs[i], mags + 3 * i, 3);
    for (int i = 0; i < 5; i++) {
        G.g1[i] = g1[i];
        G.g2[i] = g2[i];
    }
    G.g1_sign = (int)g1_sign;
    G.g2_sign = (int)g2_sign;
    g_inited = 1;
}

// c = round(k * g / 2^384) for k 4 limbs, g 5 limbs -> c fits 3 limbs
static void round_mul_shift(const u64* k, const u64* g, u64* c) {
    u64 prod[9];
    mul_nn(k, 4, g, 5, prod);
    // add 2^383 for rounding: bit 383 = limb 5, bit 63
    u128 t = (u128)prod[5] + ((u64)1 << 63);
    prod[5] = (u64)t;
    u64 carry = (u64)(t >> 64);
    for (int i = 6; i < 9 && carry; i++) {
        t = (u128)prod[i] + carry;
        prod[i] = (u64)t;
        carry = (u64)(t >> 64);
    }
    c[0] = prod[6];
    c[1] = prod[7];
    c[2] = prod[8];
}

// recode one signed value into ROWS signed base-16 digit rows
// (absd in [0,8], sgn in {0,1}), most-significant row first; column-strided
// output (stride = total number of columns).
static int recode_into(const Signed& v, u32* absd, u32* sgn, int col, int ncols) {
    u64 m[6];
    std::memcpy(m, v.mag, sizeof m);
    int neg = v.sign < 0;
    for (int j = 0; j < ROWS; j++) {
        int d = (int)(m[0] & 15);
        // shift right by 4
        for (int i = 0; i < 5; i++) m[i] = (m[i] >> 4) | (m[i + 1] << 60);
        m[5] >>= 4;
        if (d > 8) {
            d -= 16;
            // += 1 with carry
            u128 t = (u128)m[0] + 1;
            m[0] = (u64)t;
            for (int i = 1; i < 6 && (t >> 64); i++) {
                t = (u128)m[i] + 1;
                m[i] = (u64)t;
            }
        }
        int row = ROWS - 1 - j;
        absd[(size_t)row * ncols + col] = (u32)(d < 0 ? -d : d);
        sgn[(size_t)row * ncols + col] = (u32)(((d < 0) != (neg != 0)) ? 1 : 0);
    }
    return is_zero_n(m, 6) ? 0 : -1;  // -1: scalar too large (never for GLV halves)
}

// Split + recode a batch of scalars.  scalars: n * 4 u64 (LE, < group order).
// absd/sgn: (ROWS, 2n) row-major u32.  Returns 0 on success.
extern "C" int glv_recode_batch(const u64* scalars, int n, u32* absd, u32* sgn) {
    if (!g_inited) return -2;
    int ncols = 2 * n;
    for (int i = 0; i < n; i++) {
        const u64* k = scalars + 4 * i;
        u64 c1[3], c2[3];
        round_mul_shift(k, G.g1, c1);
        round_mul_shift(k, G.g2, c2);

        // k1 = k - (c1*a1 + c2*a2);  k2 = -(c1*b1 + c2*b2)
        // c rounds carry the g sign: c1_signed = g1_sign * c1 etc.
        u64 p1[6], p2[6];
        mul_nn(c1, 3, G.a1.mag, 3, p1);
        mul_nn(c2, 3, G.a2.mag, 3, p2);
        Signed s1, s2, k1, k2;
        sgn_set(s1, G.g1_sign * G.a1.sign, p1, 6);
        sgn_set(s2, G.g2_sign * G.a2.sign, p2, 6);
        u64 kk[6] = {k[0], k[1], k[2], k[3], 0, 0};
        sgn_set(k1, 1, kk, 6);
        s1.sign = -s1.sign;
        s2.sign = -s2.sign;
        sgn_add(k1, s1);
        sgn_add(k1, s2);

        mul_nn(c1, 3, G.b1.mag, 3, p1);
        mul_nn(c2, 3, G.b2.mag, 3, p2);
        Signed t1, t2;
        sgn_set(t1, -G.g1_sign * G.b1.sign, p1, 6);
        sgn_set(t2, -G.g2_sign * G.b2.sign, p2, 6);
        u64 zero6[6] = {0, 0, 0, 0, 0, 0};
        sgn_set(k2, 1, zero6, 6);
        sgn_add(k2, t1);
        sgn_add(k2, t2);

        if (recode_into(k1, absd, sgn, 2 * i, ncols)) return -1;
        if (recode_into(k2, absd, sgn, 2 * i + 1, ncols)) return -1;
    }
    return 0;
}

// Recode a single signed scalar (sign + 4 u64 magnitude) into (ROWS,) arrays.
extern "C" int recode_signed_one(int64_t sign, const u64* mag, u32* absd, u32* sgn) {
    Signed v;
    u64 m[6] = {mag[0], mag[1], mag[2], mag[3], 0, 0};
    sgn_set(v, sign < 0 ? -1 : 1, m, 6);
    return recode_into(v, absd, sgn, 0, 1);
}
