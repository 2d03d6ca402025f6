"""Kernel K2: the traceback as a CUDA kernel (``csrc/traceback.cu``).

``traceback`` takes the packed MAT planes of K1 and the group batch, and
returns a ``TbOut``: per-window extended-CIGAR bytes, lengths and bail
flags in one uint8 buffer (one device-to-host copy). On CPU tensors it runs
the plain PyTorch version (``ops/traceback.py``); on CUDA tensors it
launches the kernel on the current stream, or raises.

The kernel walks each window with one warp, streaming the window's plane
and prefix-I rows backward through a ring of ``STAGES`` tiles in shared
memory (a TMA bulk copy a tile of planes, each completing on the tile's
mbarrier). ``launch_plan`` sizes the launch from the group's shape alone.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config import AlignConfig
from . import _build
from .band_dp import LW
from .traceback import TbOut, alloc_out
from .traceback import traceback as traceback_plain

launches = 0     # kernel launches (plain-version calls are not counted)

# the kernel's constants (csrc/traceback.cu) and the card's
STAGES = 4                   # tiles in a window's ring
MAX_WARPS = 8                # windows a CTA at most
ROW_BYTES = LW * 4 + 4       # a plane row and its prefix-I count
BAR_BYTES = 8                # a tile's mbarrier
SMS = 132                    # SMs of an H100 SXM
SMEM_MAX = 227 * 1024        # dynamic shared memory a CTA can have
TILE_ALIGN = 8               # tile rows are a multiple of this


class LaunchPlan(NamedTuple):
    ctas: int
    windows_per_cta: int     # one warp each
    tile_rows: int
    stages: int
    smem_bytes: int          # dynamic shared memory a CTA


def launch_plan(B: int, R: int) -> LaunchPlan:
    """Windows a CTA so that ``B`` windows fill the SMs in one wave (at
    most ``MAX_WARPS``), then the largest tile the shared memory holds for
    that many rings, cut to the rows a window has."""
    wpc = min(MAX_WARPS, max(1, -(-B // SMS)))
    per_ring = (SMEM_MAX // wpc // STAGES - BAR_BYTES) // ROW_BYTES
    rows = -(-max(R, 1) // TILE_ALIGN) * TILE_ALIGN
    tile = max(TILE_ALIGN, min(per_ring // TILE_ALIGN * TILE_ALIGN, rows))
    return LaunchPlan(-(-B // wpc), wpc, tile, STAGES,
                      wpc * STAGES * (tile * ROW_BYTES + BAR_BYTES))


def tiles(rows: int, tile_rows: int) -> List[Tuple[int, int]]:
    """The row ranges [lo, hi) a window of ``rows`` walked rows streams,
    in the order the kernel loads them (``issue_tile``)."""
    return [(max(hi - tile_rows, 0), hi)
            for hi in range(rows, 0, -tile_rows)]


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
    if packed.data_ptr() % 16:
        raise ValueError("traceback: packed must start on a 16-byte "
                         "boundary (a TMA bulk copy reads its rows)")
    out = alloc_out(batch, L)
    if B == 0:
        return out
    plan = launch_plan(B, R)
    with torch.cuda.device(dev):        # the launch goes to dev's context
        err = _build.entry("traceback")(
            packed.data_ptr(), batch["inss"].data_ptr(),
            batch["seqbuf"].data_ptr(), batch["refbuf"].data_ptr(),
            batch["n_ins"].data_ptr(), batch["n_del"].data_ptr(),
            out.meta.data_ptr(), out.cig.data_ptr(), B, R, A,
            out.cig.shape[1], cfg.r, plan.tile_rows, plan.windows_per_cta,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "traceback")
    global launches
    launches += 1
    return out


def occupancy(B: int, R: int) -> int:
    """CTAs of K2 resident on one SM of the current card at
    ``launch_plan(B, R)``, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    plan = launch_plan(B, R)
    n = _build.entry("traceback", "npore_traceback_occupancy")(
        plan.tile_rows, plan.windows_per_cta)
    if n < 0:
        raise RuntimeError(f"traceback occupancy: CUDA error {-n}")
    return n
