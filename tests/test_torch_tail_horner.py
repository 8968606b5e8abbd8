"""The tail_horner kernel's plain PyTorch version against
tail_horner_pallas in interpret mode (its own file: interpreting the
Pallas kernel's seven roll levels and Horner loop takes about a minute on
one CPU worker).  Exact comparison of normalized projective outputs."""

import numpy as np
import pytest

pytest.importorskip("jax")

from bulletproofspp_tpu.ops import pallas_field  # noqa: E402
from bulletproofspp_tpu_torch.ops import kernels  # noqa: E402

from test_torch_kernels import _canon_jax, _canon_port, _jax, _points, _port  # noqa: E402


def test_tail_horner_plain_matches_tail_horner_pallas():
    rows = 2
    p, _ = _points(rows * 128, 20)
    want = pallas_field.tail_horner_pallas(_jax(p), rows, interpret=True)
    got = kernels.tail_horner_plain(_port(p, (16, 1, rows * 128)), rows)
    assert np.array_equal(_canon_port(got), _canon_jax(want))
