"""nPoRe realignment on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of ``npore_tpu``: the banded 5-state n-polymer DP, its
traceback and the tiered k-select probe run as hand-written CUDA kernels
for ``sm_90a``, each with a plain PyTorch version beside it that serves the
CPU and is the kernel's oracle. The port imports nothing of ``npore_tpu``:
it carries its own copies of the host modules (BAM/SAM/FASTA I/O, the
golden spec, the n-polymer scanner, the score model) and of their C++
library, which it builds into its own build directory.

Layout:
  config.py, constants.py  run configuration and base/CIGAR codes
  device.py  engine name -> torch.device (no silent CPU fallback)
  native/    C++ host library (n-polymer scan, CIGAR finalize, BAM decode)
  io/        SAM/BAM/FASTA codecs, BAM writer, pileup
  golden/    executable NumPy specification of the alignment
  model/     confusion and score matrices, plots
  ops/       score tables, plain DP, traceback and k-select, CUDA wrappers
  csrc/      CUDA C++ sources of the kernels, built with nvcc on first use
  engine/    window building, batching, the CUDA engine, the Realigner
  cli/       realign entry point (BAM -> SAM)
  scripts/   probe_cond: the tiered k-select probe (kernel K3)
  testing/   seeded synthetic reads
"""

__version__ = "0.1.0"
