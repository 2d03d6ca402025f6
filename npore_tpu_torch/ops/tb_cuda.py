"""Kernel K2: the traceback as a CUDA kernel (``csrc/traceback.cu``).

``traceback`` takes the packed MAT planes of K1 and the group batch, and
returns a ``TbOut``: per-window extended-CIGAR bytes, lengths and bail
flags in one uint8 buffer (one device-to-host copy). On CPU tensors it runs
the plain PyTorch version (``ops/traceback.py``); on CUDA tensors it
launches the kernel on the current stream, or raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import AlignConfig
from . import _build
from .band_dp import LW
from .traceback import TbOut, alloc_out
from .traceback import traceback as traceback_plain

launches = 0     # kernel launches (plain-version calls are not counted)


def traceback(packed: torch.Tensor, batch: Dict[str, torch.Tensor],
              cfg: AlignConfig, L: Optional[int] = None) -> TbOut:
    """``L``: the CIGAR buffer width, at least the largest n_ins + n_del
    (given, it saves a read back from the device)."""
    dev = packed.device
    if dev.type == "cpu":
        return traceback_plain(packed, batch, cfg, L)
    if dev.type != "cuda":
        raise ValueError(f"traceback runs on cpu or cuda tensors, not {dev}")
    B, R = batch["inss"].shape[0], batch["inss"].shape[1] - 8
    A = batch["seqbuf"].shape[1]
    for name, x, dtype, shape in (
            ("packed", packed, torch.int32, (B, R, LW)),
            ("inss", batch["inss"], torch.int32, (B, R + 8)),
            ("seqbuf", batch["seqbuf"], torch.int8, (B, A)),
            ("refbuf", batch["refbuf"], torch.int8, (B, A)),
            ("n_ins", batch["n_ins"], torch.int32, (B,)),
            ("n_del", batch["n_del"], torch.int32, (B,))):
        if x.device != dev or x.dtype != dtype or \
                tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"traceback: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    out = alloc_out(batch, L)
    if B == 0:
        return out
    err = _build.entry("traceback")(
        packed.data_ptr(), batch["inss"].data_ptr(),
        batch["seqbuf"].data_ptr(), batch["refbuf"].data_ptr(),
        batch["n_ins"].data_ptr(), batch["n_del"].data_ptr(),
        out.meta.data_ptr(), out.cig.data_ptr(), B, R, A, out.cig.shape[1],
        cfg.r, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "traceback")
    global launches
    launches += 1
    return out
