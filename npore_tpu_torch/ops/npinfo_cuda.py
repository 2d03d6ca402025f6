"""Kernel K4: the n-polymer scan as a CUDA kernel (``csrc/npinfo.cu``).

``fill_planes`` writes the four int8 n-polymer planes of a group buffer
(``l_seq``, ``lidx_seq``, ``l_ref``, ``lidx_ref``, each (B, A, max_n)) from
its ``seqbuf`` and ``refbuf`` rows, in place, with the values that
``engine/windows.pack_group`` writes on the host. A row's length is its
window's slice, from the buffer's scalars: ``min(n_ins + 1, seq_guard)``
bases of seq, ``min(n_del + 1, ref_guard)`` of ref. On CPU tensors it runs
the plain PyTorch version (``ops/npinfo_device.py``, through
``fill_planes_plain``); on CUDA tensors it launches the kernel on the
current stream, or raises.

The launch is one CTA per (window, side) row, 2B CTAs, with 7 bytes of
dynamic shared memory a row position: rows of more than about 33,000
positions do not fit a CTA, and the launch then raises.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import AlignConfig
from ..engine.windows import PLANES
from . import _build
from .band_dp import PADL
from .npinfo_device import np_info_device

launches = 0     # kernel launches (plain-version calls are not counted)

MAX_N = 8        # periods the kernel handles
LENGTHS = ("n_ins", "seq_guard", "n_del", "ref_guard")


def threads_for(A: int) -> int:
    """Threads a row: about 16 positions a thread, 128 to 1024."""
    return min(1024, max(128, 32 * -(-(A - PADL) // 512)))


def fill_planes_plain(batch: Dict[str, torch.Tensor],
                      cfg: AlignConfig) -> None:
    """The plain version of ``fill_planes``, on any device."""
    B = batch["seqbuf"].shape[0]
    rows = torch.cat([batch["seqbuf"], batch["refbuf"]])[:, PADL:]
    lengths = torch.cat([
        torch.minimum(batch["n_ins"] + 1, batch["seq_guard"]),
        torch.minimum(batch["n_del"] + 1, batch["ref_guard"])])
    L, I = np_info_device(rows, cfg.max_n, cfg.max_l, lengths)
    for name, x in zip(PLANES, (L[:B], I[:B], L[B:], I[B:])):
        batch[name][:, :PADL] = 0
        batch[name][:, PADL:] = x.transpose(1, 2).to(torch.int8)


def fill_planes(batch: Dict[str, torch.Tensor], cfg: AlignConfig) -> None:
    dev = batch["seqbuf"].device
    if dev.type == "cpu":
        return fill_planes_plain(batch, cfg)
    if dev.type != "cuda":
        raise ValueError(f"fill_planes runs on cpu or cuda tensors, not {dev}")
    B, A = batch["seqbuf"].shape
    if not 1 <= cfg.max_n <= MAX_N:
        raise ValueError(f"fill_planes: needs 1 <= max_n <= {MAX_N}")
    for name in ("seqbuf", "refbuf") + PLANES + LENGTHS:
        x = batch[name]
        shape, dt = ((B,), torch.int32) if name in LENGTHS else \
            ((B, A), torch.int8) if name.endswith("buf") else \
            ((B, A, cfg.max_n), torch.int8)
        if x.device != dev or x.dtype != dt \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"fill_planes: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if B == 0:
        return
    with torch.cuda.device(dev):        # the launch goes to dev's context
        err = _build.entry("npinfo")(
            batch["seqbuf"].data_ptr(), batch["refbuf"].data_ptr(),
            *(batch[k].data_ptr() for k in PLANES + LENGTHS), B, A,
            cfg.max_n, cfg.max_l, threads_for(A),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "npinfo")
    global launches
    launches += 1
