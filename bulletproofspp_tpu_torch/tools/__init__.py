"""Kernel measurement tools of the port: ``r5_experiments`` (select-and-reduce
variants, block counts, thread counts) and ``phase_bench`` (each phase of the
complete addition, chained).  Each needs a CUDA card."""
