"""Executable NumPy specification of the reference alignment semantics.

This package is the ground truth the device kernels are tested against:
a direct, readable implementation of the n-polymer scan, score-matrix
construction, and banded 5-state DP exactly as the reference defines them
(reference: src/aln.pyx). It is deliberately unoptimized; production paths
use ops/ (PyTorch and the CUDA kernels) and engine/. The port's copy of
``npore_tpu/golden``; ``debug`` holds its developer printers.
"""
from .npinfo import get_np_info
from .align import align
