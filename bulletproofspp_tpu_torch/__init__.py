"""Bulletproofs++ on PyTorch and CUDA: the H100 port of ``bulletproofspp_tpu``.

The protocol layer (``bulletproofspp_tpu.core``, ``.io_`` and ``.cli``)
is exact host-integer Python and is reused unchanged.  This package
supplies the device side behind its engine interface:

  ops.limb / ops.curve   Fq on (16, L) int64 planes of 16-bit limbs and the
                         complete projective group law, in plain PyTorch
  ops.kernels            the hand-written CUDA kernels (csrc/) with their
                         plain versions and launch counters
  ops.msm                GLV/Straus MSM, basis folding, square completion
  ops.engine             TorchEngine, plugged in through
                         ``core.engine.set_default_engine``
  cli                    ``python -m bulletproofspp_tpu_torch.cli``

Nothing here imports JAX.
"""
