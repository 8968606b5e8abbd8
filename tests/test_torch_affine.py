"""Device affine conversion: the port's ``limb.inv``, ``limb.batch_inv`` and
``curve.to_affine`` (+ ``affine_lanes_to_host``) against the JAX package's on
the same numpy limb planes, exactly (after ``normalize`` on the JAX side:
the port's are canonical), zeros, Q and saturated limbs among the values;
a Python transcription of the card's inverse (``csrc/field.cuh:
fe_inv_divsteps``: safegcd divsteps in batches of 30 on signed 30-bit
limbs, with the kernel's int32 / int64 arithmetic) against ``pow(a, p - 2,
p)``, and the work ``bounds`` counts for it; and ``TorchEngine("cpu")``'s
``fold_bases`` / ``shared_mul`` (``msm.run_fold``, one ``to_affine`` a call,
no host inverse) against ``JaxEngine(host_below=0)`` and ``HostEngine``.

The JAX package is imported inside the tests that compare with it, so the
file's CUDA case also runs where JAX is not installed (the machine with the
card):

    python -m pytest --noconftest -m cuda tests/test_torch_affine.py
"""

import importlib
import random

import numpy as np
import pytest
import torch

from bulletproofspp_tpu_torch import bounds
from bulletproofspp_tpu_torch.core import ec
from bulletproofspp_tpu_torch.core.engine import HostEngine
from bulletproofspp_tpu_torch.core.fields import Q, R
from bulletproofspp_tpu_torch.ops import curve, glv, kernels, limb
from bulletproofspp_tpu_torch.ops.engine import TorchEngine

# 0, 1, Q (strict, = 0 mod p), Q - 1, values in [Q, 2^256) (strict, not
# canonical) and saturated 0xFFFF runs (tests/test_pallas_forms.py:35-45)
EDGE = [
    0, 1, Q, Q - 1, Q - 2, Q + 1, (1 << 256) - 1, (1 << 256) % Q,
    0xFFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFF,
    int("FFFF" * 8 + "0000" * 8, 16),
    int("FFFF0000" * 8, 16),
    pow(2**200 + 7, 2, Q),
]


def _jax(module: str):
    """A module of the JAX package (the test skips where JAX is missing)."""
    pytest.importorskip("jax")
    return importlib.import_module(f"bulletproofspp_tpu.{module}")


def _values(n: int, seed: int) -> list:
    """EDGE, then numpy-seeded randoms over the full 256-bit range: n in all."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(n - len(EDGE))]
    return (EDGE + rand)[:n]


def _inverses(vals) -> list:
    return [pow(v, -1, Q) if v % Q else 0 for v in vals]


def _as_numpy(t) -> np.ndarray:
    return limb.planes_to_numpy(t)


# --- csrc/field.cuh: fe_inv_divsteps, transcribed ---------------------------
# Every value is a Python int held to the C type the kernel gives it: _u32 /
# _i32 wrap as the casts do, _i64 asserts that an int64 accumulator of the
# kernel would not overflow.  _MULS counts the 32-bit multiplies the kernel
# issues (a 32 x 32 -> 64 product as two, the low word of p^-1 cd as one; p's
# limbs 1 and 8, -4 and 2^16, are shifts).

M30 = (1 << 30) - 1
P_INV30 = 0x2DDACACF  # field.cuh: kPInv30
_MULS = [0]


def _u32(x: int) -> int:
    return x & 0xFFFFFFFF


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >> 31 else x


def _i64(x: int) -> int:
    assert -(1 << 63) <= x < 1 << 63, "an int64 accumulator overflows"
    return x


def _p30(i: int) -> int:
    return {0: -977, 1: -4, 8: 65536}.get(i, 0)


def _mul64(a: int, b: int) -> int:
    _MULS[0] += 2
    return a * b


def _s30_from_fe(w: list) -> list:
    out = []
    for i in range(9):
        k, s = 30 * i // 32, 30 * i % 32
        x = w[k] >> s
        if s > 2 and k + 1 < 8:
            x |= _u32(w[k + 1] << (32 - s))
        out.append(_i32(x & M30))
    return out


def _fe_from_s30(v: list) -> list:
    out = []
    for k in range(8):
        i, s = 32 * k // 30, 32 * k % 30
        out.append(_u32((_u32(v[i]) >> s) | (_u32(v[i + 1]) << (30 - s))))
    return out


def _divsteps_30(zeta: int, f: int, g: int):
    u, v, q, r = 1, 0, 0, 1
    for _ in range(bounds.DIVSTEPS_A_BATCH):
        c1 = _u32(zeta >> 31)
        c2 = _u32(-(g & 1))
        x, y, z = _u32((f ^ c1) - c1), _u32((u ^ c1) - c1), _u32((v ^ c1) - c1)
        g, q, r = _u32(g + (x & c2)), _u32(q + (y & c2)), _u32(r + (z & c2))
        c3 = c1 & c2
        zeta = _i32((_u32(zeta) ^ c3) - 1)
        f, u, v = _u32(f + (g & c3)), _u32(u + (q & c3)), _u32(v + (r & c3))
        g, u, v = g >> 1, _u32(u << 1), _u32(v << 1)
    return zeta, (_i32(u), _i32(v), _i32(q), _i32(r))


def _update_de_30(d: list, e: list, t) -> tuple:
    u, v, q, r = t
    sd, se = d[8] >> 31, e[8] >> 31
    md, me = _i32((u & sd) + (v & se)), _i32((q & sd) + (r & se))
    cd = _i64(_mul64(u, d[0]) + _mul64(v, e[0]))
    ce = _i64(_mul64(q, d[0]) + _mul64(r, e[0]))
    _MULS[0] += 2
    md = _i32(md - (_u32(P_INV30 * _u32(cd) + _u32(md)) & M30))
    me = _i32(me - (_u32(P_INV30 * _u32(ce) + _u32(me)) & M30))
    cd, ce = _i64(cd + _mul64(_p30(0), md)), _i64(ce + _mul64(_p30(0), me))
    assert cd & M30 == 0 and ce & M30 == 0
    cd, ce = cd >> 30, ce >> 30
    nd, ne = [0] * 9, [0] * 9
    for i in range(1, 9):
        cd = _i64(cd + _mul64(u, d[i]) + _mul64(v, e[i]))
        ce = _i64(ce + _mul64(q, d[i]) + _mul64(r, e[i]))
        if _p30(i):
            cd, ce = _i64(cd + _p30(i) * md), _i64(ce + _p30(i) * me)
        nd[i - 1], ne[i - 1] = _i32(cd) & M30, _i32(ce) & M30
        cd, ce = cd >> 30, ce >> 30
    assert _i32(cd) == cd and _i32(ce) == ce
    nd[8], ne[8] = cd, ce
    return nd, ne


def _update_fg_30(f: list, g: list, t) -> tuple:
    u, v, q, r = t
    cf = _i64(_mul64(u, f[0]) + _mul64(v, g[0]))
    cg = _i64(_mul64(q, f[0]) + _mul64(r, g[0]))
    assert cf & M30 == 0 and cg & M30 == 0
    cf, cg = cf >> 30, cg >> 30
    nf, ng = [0] * 9, [0] * 9
    for i in range(1, 9):
        cf = _i64(cf + _mul64(u, f[i]) + _mul64(v, g[i]))
        cg = _i64(cg + _mul64(q, f[i]) + _mul64(r, g[i]))
        nf[i - 1], ng[i - 1] = _i32(cf) & M30, _i32(cg) & M30
        cf, cg = cf >> 30, cg >> 30
    assert _i32(cf) == cf and _i32(cg) == cg
    nf[8], ng[8] = cf, cg
    return nf, ng


def _s30_normalize(r: list, sign: int) -> list:
    r = list(r)

    def carry():
        for i in range(8):
            r[i + 1] = _i32(r[i + 1] + (r[i] >> 30))
            r[i] &= M30

    add = r[8] >> 31
    r = [_i32(x + (_p30(i) & add)) for i, x in enumerate(r)]
    neg = sign >> 31
    r = [_i32((x ^ neg) - neg) for x in r]
    carry()
    add = r[8] >> 31
    r = [_i32(x + (_p30(i) & add)) for i, x in enumerate(r)]
    carry()
    return r


def _inv_divsteps(a: int) -> int:
    """fe_inv_divsteps of the strict value a < 2^256: a^-1 mod p, 0 -> 0."""
    a = a - Q if a >= Q else a  # fe_canon
    d, e, f = [0] * 9, [1] + [0] * 8, [_p30(i) for i in range(9)]
    g = _s30_from_fe([(a >> (32 * k)) & 0xFFFFFFFF for k in range(8)])
    zeta = -1
    for _ in range(bounds.DIVSTEP_BATCHES):
        zeta, t = _divsteps_30(zeta, _u32(f[0]), _u32(g[0]))
        d, e = _update_de_30(d, e, t)
        f, g = _update_fg_30(f, g, t)
    assert g == [0] * 9 and (f in ([1] + [0] * 8, [M30] * 8 + [-1]) or a == 0)
    words = _fe_from_s30(_s30_normalize(d, f[8]))
    return sum(w << (32 * k) for k, w in enumerate(words))


def test_inv_chain_is_p_minus_2_and_inverts_integers():
    """The transcribed divstep schedule gives a^(p-2) mod p, the inverse
    (0 -> 0), on the edge values and numpy-seeded randoms; the kernel's
    constant is p^-1 mod 2^30 and its schedule 20 batches of 30 divsteps
    (590 suffice for 256 bits)."""
    assert P_INV30 == pow(Q, -1, 1 << 30)
    assert (bounds.DIVSTEP_BATCHES, bounds.DIVSTEPS_A_BATCH) == (20, 30)
    assert bounds.DIVSTEP_BATCHES * bounds.DIVSTEPS_A_BATCH >= 590
    assert bounds.inv_chain() == bounds.to_affine_chain() == 20
    for a in _values(40, 3):
        assert _inv_divsteps(a) == pow(a, Q - 2, Q) == _inverses([a])[0]


@pytest.mark.parametrize("a", [0, 1, Q - 1, Q, Q + 1, (1 << 256) - 1, 2, (Q - 1) // 2, 1 << 255,
                               (1 << 256) - 1 - (1 << 32)])
def test_divstep_transcription_equals_pow_on_edge_values(a):
    """0 and p (0 mod p) -> 0; p + 1 and 2^256 - 1 (strict, not canonical)
    are made canonical first, as the kernel's fe_canon does."""
    assert _inv_divsteps(a) == pow(a, Q - 2, Q)


@pytest.mark.parametrize("seed", [0, 1])
def test_divstep_transcription_equals_pow_on_random_values(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        a = int.from_bytes(rng.bytes(32), "little")
        assert _inv_divsteps(a) == pow(a, Q - 2, Q)


def test_inv_and_to_affine_work_count_the_chain():
    """bounds.INV is the multiplies the transcription issues: 20 batches of
    150 (DIVSTEP_BATCH); to_affine adds its two products."""
    _MULS[0] = 0
    _inv_divsteps(12345)
    assert _MULS[0] == bounds.INV == 20 * bounds.DIVSTEP_BATCH == 20 * 150
    assert bounds.inv(4096) == (4096 * bounds.INV, 4096 * 2 * 128)
    assert bounds.to_affine(16) == (16 * (bounds.INV + 2 * bounds.FE_MUL), 16 * (5 * 128 + 1))


@pytest.mark.parametrize("n", [16, 40])
def test_inv_equals_the_jax_package(n):
    jlimb = _jax("ops.limb")
    vals = _values(n, n)
    packed = limb.pack_ints(vals)
    got = limb.inv(limb.planes_from_numpy(packed, "cpu"))
    assert np.array_equal(_as_numpy(got), np.asarray(jlimb.normalize(jlimb.inv(packed))))
    assert limb.unpack_ints(got) == _inverses(vals)


@pytest.mark.parametrize("shape,axis", [((24,), -1), ((3, 8), -1), ((3, 8), 1)])
def test_batch_inv_equals_the_jax_package(shape, axis):
    """Zeros (0 and Q) map to zero; along either batch axis the same
    canonical inverses as the JAX package's two associative scans."""
    jlimb = _jax("ops.limb")
    vals = _values(int(np.prod(shape)), 7 + len(shape))
    packed = limb.pack_ints(vals).reshape(16, *shape)
    got = limb.batch_inv(limb.planes_from_numpy(packed, "cpu"), axis)
    want = jlimb.normalize(jlimb.batch_inv(packed, axis % (len(shape) + 1)))
    assert np.array_equal(_as_numpy(got), np.asarray(want))
    assert limb.unpack_ints(got.reshape(16, -1)) == _inverses(vals)
    assert torch.equal(got, kernels.inv_plain(limb.planes_from_numpy(packed, "cpu")))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_batch_inv_refuses_the_limb_axis(device):
    """Axis 0 is refused before the device is looked at: on the CPU and on
    any other device (``meta`` stands in for the card here)."""
    with pytest.raises(ValueError, match="limb axis"):
        limb.batch_inv(torch.ones(16, 2, dtype=torch.int64, device=device), 0)


def _points(n: int, seed: int) -> list:
    """n affine points, every 5th lane (from lane 2) None."""
    rng = random.Random(seed)
    return [None if i % 5 == 2 else ec.scalar_mul(rng.randrange(1, R), ec.G) for i in range(n)]


def test_to_affine_of_doubled_points_equals_the_jax_package():
    """pdbl'd lanes (Z not 1) with None lanes (tests/test_ops_curve_msm.py:49-54)."""
    jcurve = _jax("ops.curve")
    pts = _points(24, 11)
    xn, yn, inf = jcurve.to_affine(jcurve.pdbl(jcurve.from_affine_host(pts)))
    got = curve.to_affine(curve.pdbl(curve.from_affine_host(pts, "cpu")))
    for a, b in zip(got, (xn, yn, inf)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    want = [None if p is None else ec.dbl(p) for p in pts]
    assert curve.affine_lanes_to_host(*got) == jcurve.affine_lanes_to_host(xn, yn, inf) == want


def test_to_affine_of_edge_lanes_equals_the_jax_package():
    """Raw strict planes: z = 0, Q, Q - 1, x = 0 and saturated limbs among
    the lanes; where z = 0 mod p, x and y are 0 and inf is set."""
    jcurve = _jax("ops.curve")
    xs, ys, zs = _values(40, 21), _values(40, 22)[::-1], _values(40, 23)
    xs[5] = 0
    planes = [limb.pack_ints(v) for v in (xs, ys, zs)]
    want = jcurve.to_affine(tuple(planes))
    got = curve.to_affine(tuple(limb.planes_from_numpy(p, "cpu") for p in planes))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    host = [None if z % Q == 0 else (x * pow(z, -1, Q) % Q, y * pow(z, -1, Q) % Q)
            for x, y, z in zip(xs, ys, zs)]
    assert curve.affine_lanes_to_host(*got) == host
    assert [limb.unpack_ints(c) for c in got[:2]] == [
        [0 if h is None else h[i] for h in host] for i in (0, 1)]


ENGINE = TorchEngine("cpu")


@pytest.mark.parametrize("n", [16, 40])
def test_fold_bases_and_shared_mul_equal_the_jax_and_host_engines(n):
    """None lanes, zero scalars, a negative fold scalar; 40 lanes pad to a
    bucket of 64 (identity lanes in the port, G in the JAX package)."""
    jeng = _jax("ops.engine").JaxEngine(host_below=0)
    host = HostEngine()
    rng = random.Random(n)
    even, odd = _points(n, n), _points(n, 100 + n)
    for b, a in ((rng.randrange(2**127), -rng.randrange(2**127)), (0, rng.randrange(2**127)),
                 (0, 0)):
        got = ENGINE.fold_bases(b, a, even, odd)
        assert got == host.fold_bases(b, a, even, odd) == jeng.fold_bases(b, a, even, odd), (b, a)
    for k in (rng.randrange(R), 0, R - 1):
        got = ENGINE.shared_mul(k, even)
        assert got == host.shared_mul(k, even) == jeng.shared_mul(k, even), k


def test_fold_phi_plain_equals_the_jax_run_fold_after_endo():
    """``kernels.fold_phi`` on the CPU (its plain version: fold_many_plain of
    P and endo(P)) at 16 lanes, None lanes among them, then to affine: x, y
    and inf equal to the JAX package's ``run_fold(P, curve.endo(P), ...)``
    with the GLV halves' digits."""
    jcurve, jmsm, jglv = _jax("ops.curve"), _jax("ops.msm"), _jax("ops.glv")
    jnp = pytest.importorskip("jax.numpy")
    pts = _points(16, 31)
    k = random.Random(32).randrange(R)
    k1, k2 = glv.split(k)
    digits = np.stack([*glv.recode_signed(k1), *glv.recode_signed(k2)])
    assert np.array_equal(digits, np.stack([*jglv.recode_signed(k1), *jglv.recode_signed(k2)]))
    got = kernels.to_affine_plain(*kernels.fold_phi(curve.from_affine_host(pts, "cpu"),
                                                    digits[None]))
    jp = jcurve.from_affine_host(pts)
    want = jmsm.run_fold(*jp, *jcurve.endo(jp), *(jnp.asarray(d) for d in digits))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert curve.affine_lanes_to_host(*got) == HostEngine().shared_mul(k, pts)


def test_fold_bases_and_shared_mul_convert_once_on_the_device(monkeypatch):
    """One to_affine a call, on the fold's lanes; no host inverse."""
    calls = []
    inner = kernels.to_affine
    monkeypatch.setattr(kernels, "to_affine",
                        lambda *p: calls.append(p[0].shape) or inner(*p))

    def no_host_inverse(arr):
        raise AssertionError("a lane went through the host inverse")

    monkeypatch.setattr(curve, "affine_from_normalized", no_host_inverse)
    pts = _points(17, 5)
    assert ENGINE.fold_bases(3, 5, pts, pts[::-1]) == HostEngine().fold_bases(3, 5, pts, pts[::-1])
    assert ENGINE.shared_mul(7, pts) == HostEngine().shared_mul(7, pts)
    assert calls == [(16, 32), (16, 32)]


@pytest.mark.cuda
def test_cuda_inv_and_to_affine_match_plain_versions():
    """On the card: both kernels equal their plain versions word for word
    (canonical outputs) on the edge values, limb.batch_inv launches inv,
    and fold_bases / shared_mul equal HostEngine's with one to_affine
    launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dev = torch.device("cuda")
    kernels.reset_counts()
    a = limb.from_ints(_values(512, 1), dev)
    assert torch.equal(kernels.inv(a), kernels.inv_plain(a))
    assert torch.equal(limb.batch_inv(a), limb.batch_inv_plain(a))
    with pytest.raises(ValueError, match="limb axis"):
        limb.batch_inv(a, 0)
    p = tuple(limb.from_ints(_values(512, s), dev) for s in (2, 3, 4))
    for got, want in zip(kernels.to_affine(*p), kernels.to_affine_plain(*p)):
        assert torch.equal(got, want)
    assert (kernels.counts()["inv"], kernels.counts()["to_affine"]) == (2, 1)
    eng, pts = TorchEngine(dev), _points(40, 9)
    assert eng.fold_bases(3, -5, pts, pts[::-1]) == HostEngine().fold_bases(3, -5, pts, pts[::-1])
    assert eng.shared_mul(R - 1, pts) == HostEngine().shared_mul(R - 1, pts)
    assert kernels.counts()["to_affine"] == 3
