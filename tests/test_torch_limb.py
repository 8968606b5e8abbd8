"""The PyTorch port's field (bulletproofspp_tpu_torch.ops.limb) against the
JAX package's (bulletproofspp_tpu.ops.limb) and exact Python integers.

Both packages get the same numpy limb planes.  Operands: numpy-seeded
randoms, saturated 0xFFFF runs and boundary values (the class of
tests/test_pallas_forms.py:37-50) and the round-2 dropped-carry operand
(tests/test_ops_limb.py:149-164).  Integer arithmetic: equality is exact.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bulletproofspp_tpu.core.fields import Q  # noqa: E402
from bulletproofspp_tpu.ops import limb as jlimb  # noqa: E402
from bulletproofspp_tpu_torch.ops import limb  # noqa: E402

DROPPED_CARRY = 94329926858193610711403129864407773699609837703255222953893265490612872160623
SAT = [
    Q - 1, Q - 2, Q, Q + 1, (1 << 256) - 1, (1 << 256) - 2, (1 << 256) % Q,
    0xFFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFF_FFFF,
    int("FFFF" * 8 + "0000" * 8, 16),
    int("FFFF0000" * 8, 16),
    DROPPED_CARRY, pow(2**200 + 7, 2, Q), 0, 1, 2,
]


def _operands(seed: int, n: int = 24):
    """(16, len(SAT) + n) uint32 planes: the adversarial values, then
    numpy-seeded randoms over the full 256-bit range."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    return np.concatenate([jlimb.pack_ints(SAT), rand], axis=1)


A = _operands(1)
B = np.ascontiguousarray(_operands(2)[:, ::-1])
VA, VB = jlimb.unpack_ints(A), jlimb.unpack_ints(B)


def _t(arr):
    return limb.planes_from_numpy(arr, "cpu")


def _strict(t):
    assert int(t.min()) >= 0 and int(t.max()) <= limb.MASK
    return t


def _vals(t):
    return limb.unpack_ints(limb.normalize(_strict(t)))


BINARY = {
    "add": (limb.add, jlimb.add, lambda a, b: a + b),
    "sub": (limb.sub, jlimb.sub, lambda a, b: a - b),
    "mul": (limb.mul, jlimb.mul, lambda a, b: a * b),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_match_jax_and_ints(name):
    port, ref, exact = BINARY[name]
    got = _vals(port(_t(A), _t(B)))
    want_jax = jlimb.unpack_ints(np.asarray(jlimb.normalize(ref(jnp.asarray(A), jnp.asarray(B)))))
    assert got == want_jax == [exact(a, b) % Q for a, b in zip(VA, VB)]


UNARY = {
    "neg": (limb.neg, jlimb.neg, lambda a: -a),
    "sqr": (limb.sqr, jlimb.sqr, lambda a: a * a),
    "mul_small_21": (lambda a: limb.mul_small(a, 21), lambda a: jlimb.mul_small(a, 21), lambda a: 21 * a),
    "mul_small_8": (lambda a: limb.mul_small(a, 8), lambda a: jlimb.mul_small(a, 8), lambda a: 8 * a),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops_match_jax_and_ints(name):
    port, ref, exact = UNARY[name]
    got = _vals(port(_t(A)))
    want_jax = jlimb.unpack_ints(np.asarray(jlimb.normalize(ref(jnp.asarray(A)))))
    assert got == want_jax == [exact(a) % Q for a in VA]


def test_normalize_is_canonical():
    got = limb.unpack_ints(limb.normalize(_t(A)))
    assert got == jlimb.unpack_ints(np.asarray(jlimb.normalize(jnp.asarray(A))))
    assert got == [a % Q for a in VA]


def test_predicates_match_jax():
    a, b = _t(A), _t(B)
    ja, jb = jnp.asarray(A), jnp.asarray(B)
    assert limb.is_zero(a).tolist() == np.asarray(jlimb.is_zero(ja)).tolist()
    assert limb.is_zero(a).tolist() == [x % Q == 0 for x in VA]
    assert limb.eq(a, b).tolist() == np.asarray(jlimb.eq(ja, jb)).tolist()
    assert limb.eq(a, a).all()
    assert limb.gt(a, b).tolist() == np.asarray(jlimb.gt(ja, jb)).tolist()
    assert limb.gt(a, b).tolist() == [x > y for x, y in zip(VA, VB)]
    mask = np.arange(A.shape[1]) % 3 == 0
    got = limb.select(torch.as_tensor(mask), a, b)
    assert np.array_equal(limb.planes_to_numpy(got), np.asarray(jlimb.select(jnp.asarray(mask), ja, jb)))


def test_sqrt_candidate_matches_jax():
    vs = [0, 1] + [pow(x, 2, Q) for x in (3, 5, 2**200 + 7, DROPPED_CARRY)] + [Q - 1, 7]
    arr = jlimb.pack_ints(vs)
    got = limb.unpack_ints(limb.normalize(limb.sqrt_candidate(_t(arr))))
    want = jlimb.unpack_ints(np.asarray(jlimb.normalize(jlimb.sqrt_candidate(jnp.asarray(arr)))))
    assert got == want == [pow(v, (Q + 1) // 4, Q) for v in vs]


def test_dropped_carry_operand():
    a = _t(jlimb.pack_ints([DROPPED_CARRY] * 8))
    assert _vals(limb.mul(a, a)) == [DROPPED_CARRY * DROPPED_CARRY % Q] * 8


def test_mul_loose_at_its_input_bound():
    """Limbs at MUL_IN_MAX (lazy sums and differences can reach it): the
    int64 column sums and folds must not overflow, the output is loose."""
    rng = np.random.default_rng(3)
    a = torch.full((16, 4), limb.MUL_IN_MAX, dtype=torch.int64)
    b = torch.as_tensor(rng.integers(0, limb.MUL_IN_MAX + 1, size=(16, 4)))
    b[:, 0] = limb.MUL_IN_MAX
    r = limb.mul_loose(a, b)
    assert int(r.min()) >= 0 and int(r.max()) <= limb.LOOSE_MAX

    def val(t, j):
        return sum(int(t[i, j]) << (16 * i) for i in range(16))

    for j in range(4):
        assert val(r, j) % Q == val(a, j) * val(b, j) % Q
    assert _vals(limb.tighten(r, limb.LOOSE_MAX)) == [val(a, j) * val(b, j) % Q for j in range(4)]


def test_plane_round_trip():
    t = limb.planes_from_numpy(A, "cpu")
    assert t.dtype == torch.int64
    assert np.array_equal(limb.planes_to_numpy(t), A)
    assert limb.unpack_ints(t) == VA
    assert np.array_equal(limb.pack_ints(VA), jlimb.pack_ints(VA))


@pytest.mark.parametrize("vals", [SAT + VA, []], ids=["values", "empty"])
def test_pack_unpack_match_jax_package(vals):
    """The port's vectorized host packing against the JAX package's
    per-value loop, both ways, from numpy and from a tensor."""
    got = limb.pack_ints(vals)
    assert got.dtype == np.uint32 and np.array_equal(got, jlimb.pack_ints(vals))
    assert limb.unpack_ints(got) == jlimb.unpack_ints(got) == [int(v) for v in vals]
    assert limb.unpack_ints(_t(got)) == [int(v) for v in vals]
