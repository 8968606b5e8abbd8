"""Protocol layer of the port: field/curve ground truth, transcript,
arguments, range proofs and batch verification, in exact host integers.
A copy of ``bulletproofspp_tpu.core`` with the same module names; the
device work goes through the engine interface of ``core.engine``."""
