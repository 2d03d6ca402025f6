"""Score tables, plain PyTorch DP and traceback, and the CUDA kernel
wrappers."""
