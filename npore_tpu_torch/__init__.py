"""nPoRe realignment on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of ``npore_tpu``: the banded 5-state n-polymer DP and its
traceback run as hand-written CUDA kernels for ``sm_90a``, each with a
plain PyTorch version beside it that serves the CPU and is the kernel's
oracle. Host I/O, the golden spec, the n-polymer scanner and the score
model are shared with ``npore_tpu`` (modules that load no JAX).

Layout:
  device.py  engine name -> torch.device (no silent CPU fallback)
  ops/       score tables, plain DP and traceback, CUDA kernel wrappers
  csrc/      CUDA C++ sources of the kernels, built with nvcc on first use
  engine/    window building, batching, the CUDA engine, the Realigner
  cli/       realign entry point (BAM -> SAM)
"""

__version__ = "0.1.0"
