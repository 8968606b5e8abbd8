"""Command-line interface of the PyTorch port: prove / verify / test / batch-verify.

Usage:
  python -m bulletproofspp_tpu_torch.cli prove  [spec] [witness] [commits] [proof] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli verify [spec] [commits] [proof] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli test   [spec] [witness] [commits] [proof] [--device cuda|cpu]
  python -m bulletproofspp_tpu_torch.cli batch-verify spec coms1 proof1 [coms2 proof2 ...] [--device cuda|cpu]

``batch-verify`` decodes N same-schema proofs (one batched device
decompress) and checks them as one merged zero-check MSM
(``bulletproofspp_tpu.core.batch.batch_verify_encoded``); it prints
``Batch of N: True|False`` and exits 0 or 1.

Installs ``TorchEngine(device)`` as the process's engine and hands the
command to ``bulletproofspp_tpu.cli.main`` (the shared, JAX-free protocol
CLI).  The default device is ``cuda``; without CUDA it raises rather than
run on the CPU.  ``--engine`` (host/jax) belongs to the JAX package's CLI
and is refused.
"""

from __future__ import annotations

import argparse
import sys

import torch

from bulletproofspp_tpu import cli as base_cli
from bulletproofspp_tpu.core.engine import set_default_engine

from .ops.engine import TorchEngine

COMMANDS = ("prove", "verify", "test", "batch-verify")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(prog="bulletproofspp-tpu-torch", add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", default=None)
    opts, rest = ap.parse_known_args(argv)
    if opts.engine is not None:
        ap.error("--engine is the JAX package's option; this CLI takes --device")
    if not rest or rest[0] not in COMMANDS:
        ap.error(f"command must be one of {', '.join(COMMANDS)}")
    if torch.device(opts.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    set_default_engine(TorchEngine(opts.device))
    return base_cli.main(rest)


if __name__ == "__main__":
    sys.exit(main())
