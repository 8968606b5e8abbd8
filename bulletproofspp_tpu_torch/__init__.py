"""Bulletproofs++ on PyTorch and CUDA: the H100 port of ``bulletproofspp_tpu``.

The protocol layer is exact host-integer Python, copied from the JAX
package with the same module names; the device side sits behind its
engine interface:

  core / io_             the protocol layer: fields, curve, transcript,
                         arguments, range proofs, batch verification,
                         schemas (a copy of ``bulletproofspp_tpu.core`` /
                         ``.io_``)
  ops.limb / ops.curve   Fq on (16, L) int64 planes of 16-bit limbs and the
                         complete projective group law, in plain PyTorch
  ops.kernels            the hand-written CUDA kernels (csrc/) with their
                         plain versions and launch counters
  ops.msm                GLV/Straus MSM, basis folding, square completion
  ops.engine             TorchEngine, the default engine of ``core.engine``
  cli                    ``python -m bulletproofspp_tpu_torch.cli``
  bench, tools           the MSM bench and the kernel measurement tools

Nothing here imports JAX or the JAX package.
"""
