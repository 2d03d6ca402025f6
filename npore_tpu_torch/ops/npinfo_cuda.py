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

The launch is one CTA per (window, side) row, 2B CTAs; ``launch_plan``
sizes it from the row width alone: threads a row, and staged or not. A
staged CTA keeps the window's two planes in shared memory and writes each
once with 16-byte stores; rows whose staging does not fit the shared
memory (whole-contig windows) write each period's bytes as it ends. Rows
wider than ``largest_A(max_n)`` bytes fit neither way, and the launch then
raises.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..config import AlignConfig
from ..engine.windows import PLANES
from . import _build
from .band_dp import PADL
from .npinfo_device import np_info_device

launches = 0     # kernel launches (plain-version calls are not counted)

MAX_N = 8        # periods the kernel handles
LENGTHS = ("n_ins", "seq_guard", "n_del", "ref_guard")
# the kernel's shared memory (csrc/npinfo.cu) and the card's
ST_BYTES = 12                # a scan triple
SMEM_MAX = 227 * 1024        # dynamic shared memory a CTA can have


class LaunchPlan(NamedTuple):
    threads: int
    staged: bool             # planes staged in shared memory
    smem_bytes: int          # dynamic shared memory a CTA


def threads_for(A: int) -> int:
    """Threads a row: about 16 positions a thread, 128 to 1024."""
    return min(1024, max(128, 32 * -(-(A - PADL) // 512)))


def row_bytes(A: int) -> int:
    return (A - PADL + 15) & ~15


def smem_bytes(A: int, max_n: int, staged: bool) -> int:
    """A CTA's shared memory (the kernel's ``smem_bytes``): the row and a
    byte a position, the two staged planes (each A * max_n bytes, placed
    at its offset mod 16) or 4 bytes a position, the scan's 32 * max_n
    triples and the suffix-min's 32 ints."""
    per_row = 2 * row_bytes(A) + 2 * ((A * max_n + 30) & ~15) if staged \
        else 6 * row_bytes(A)
    return per_row + 32 * max_n * ST_BYTES + 128


def largest_A(max_n: int) -> int:
    """The widest row buffer whose CTA fits the shared memory, staged or
    not (staged takes less at max_n 1)."""
    lo, hi = PADL + 1, PADL + SMEM_MAX
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if min(smem_bytes(mid, max_n, s) for s in (True, False)) <= SMEM_MAX:
            lo = mid
        else:
            hi = mid - 1
    return lo


def launch_plan(A: int, max_n: int) -> LaunchPlan:
    """The launch of a group whose rows are ``A`` bytes wide: staged where
    that fits."""
    for staged in (True, False):
        smem = smem_bytes(A, max_n, staged)
        if smem <= SMEM_MAX:
            return LaunchPlan(threads_for(A), staged, smem)
    raise ValueError(f"fill_planes: rows of {A} bytes need {smem} bytes "
                     f"of shared memory a CTA, more than {SMEM_MAX}")


def occupancy(A: int, max_n: int) -> int:
    """CTAs of K4 resident on one SM of the current card at
    ``launch_plan(A, max_n)``, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    plan = launch_plan(A, max_n)
    n = _build.entry("npinfo", "npore_npinfo_occupancy")(
        A, max_n, plan.threads, int(plan.staged))
    if n < 0:
        raise RuntimeError(f"npinfo occupancy: CUDA error {-n}")
    return n


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
    plan = launch_plan(A, cfg.max_n)
    with torch.cuda.device(dev):        # the launch goes to dev's context
        err = _build.entry("npinfo")(
            batch["seqbuf"].data_ptr(), batch["refbuf"].data_ptr(),
            *(batch[k].data_ptr() for k in PLANES + LENGTHS), B, A,
            cfg.max_n, cfg.max_l, plan.threads, int(plan.staged),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "npinfo")
    global launches
    launches += 1
