"""Kernel K3: the two-tier k-select as a CUDA kernel (``csrc/tier_select.cu``).

``tier_select`` takes x (W, Qx, LANES) float32, the step count and the
number of rows ``q`` the ladder reads, and returns the (W, LANES) float32
sums. On CPU tensors it runs the plain PyTorch version
(``ops/tier_select.py``); on CUDA tensors it launches the kernel on the
current stream, or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .tier_select import tier_select_plain

launches = 0     # kernel launches (plain-version calls are not counted)

WARP = 32        # elements of the row-major (W, LANES) output a tier vote


def tier_select(x: torch.Tensor, n_steps: int, q: int,
                run0: Optional[torch.Tensor] = None) -> torch.Tensor:
    dev = x.device
    if dev.type == "cpu":
        return tier_select_plain(x, n_steps, q, run0)
    if dev.type != "cuda":
        raise ValueError(f"tier_select runs on cpu or cuda tensors, not {dev}")
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"tier_select: x must be a contiguous float32 "
                         f"(W, Qx, LANES) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    W, qx, lanes = x.shape
    if not 1 <= q <= qx:
        raise ValueError(f"tier_select: need 1 <= q <= Qx = {qx}, got {q}")
    if n_steps < 0:
        raise ValueError(f"tier_select: n_steps must be >= 0, got {n_steps}")
    if run0 is not None and (
            run0.device != dev or run0.dtype != torch.int32
            or tuple(run0.shape) != (W, lanes) or not run0.is_contiguous()):
        raise ValueError(f"tier_select: run0 must be a contiguous int32 "
                         f"{(W, lanes)} tensor on {dev}, got {run0.dtype} "
                         f"{tuple(run0.shape)} on {run0.device}")
    out = torch.empty(W, lanes, dtype=torch.float32, device=dev)
    if W == 0 or lanes == 0:
        return out
    err = _build.entry("tier_select")(
        x.data_ptr(), None if run0 is None else run0.data_ptr(),
        out.data_ptr(), W, qx, q, lanes, n_steps,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tier_select")
    global launches
    launches += 1
    return out
