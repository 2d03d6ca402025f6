"""Kernel K1: the banded DP as a CUDA kernel (``csrc/band_dp.cu``).

``band_dp`` takes the batch of ``engine/windows.pack_group`` (int8 planes
and sequences, int32 prefix-I counts and scalars) and the score tables, and
returns the packed MAT planes ``typ | run << 3`` as int32 (B, R, 64).
On CPU tensors it runs the plain PyTorch version (``ops/band_dp.py``); on
CUDA tensors it launches the kernel on the current stream, or raises.

The launch is one CTA of 64 threads per window, ``B`` CTAs, no dynamic
shared memory. The kernel is row-latency bound. Its first design held a
15-array x 8-row state ring (30,720 B of shared memory a CTA, 7 CTAs an
SM), so a group of ``GROUP_WINDOWS`` = 1024 windows ran in two waves on
132 SMs, and each row waited on serial global loads before its first
select. The kernel now sizes each ring by how far back it is read and
stages the window's bases and n-polymer planes by tiles of rows (22,952 B
a CTA), and caps registers at 128 (``__launch_bounds__(64, 8)``), so 8
CTAs fit an SM and a group is one wave; it computes the state-free inputs
of each row one row ahead, so the row chain holds only shared-memory
reads, the continue-case lookups, the selects and one barrier. With 8 CTAs
an SM, the SM's instruction issue, not waves, bounds a full group.
``occupancy(cfg)`` reports the resident CTAs per SM.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import AlignConfig
from . import _build
from .band_dp import LW, check_band, pack_planes, window_dp

launches = 0     # kernel launches (plain-version calls are not counted)

_INT8 = ("seqbuf", "refbuf", "l_seq", "lidx_seq", "l_ref", "lidx_ref")
_INT32 = ("inss", "b_rows", "n_ins", "n_del", "ref_guard", "seq_guard")


def band_dp(batch: Dict[str, torch.Tensor], tables: Dict[str, torch.Tensor],
            cfg: AlignConfig) -> torch.Tensor:
    dev = batch["inss"].device
    if dev.type == "cpu":
        return pack_planes(*window_dp(batch, tables, cfg))
    if dev.type != "cuda":
        raise ValueError(f"band_dp runs on cpu or cuda tensors, not {dev}")
    check_band(cfg)
    B, R = batch["inss"].shape[0], batch["inss"].shape[1] - 8
    A = batch["seqbuf"].shape[1]
    shapes = {"seqbuf": (B, A), "refbuf": (B, A), "inss": (B, R + 8)}
    for k in _INT8 + _INT32:
        want = torch.int8 if k in _INT8 else torch.int32
        shape = shapes.get(k, (B, A, cfg.max_n) if k in _INT8 else (B,))
        _check(batch[k], k, want, shape, dev)
    _check(tables["sub"], "sub", torch.float32, (25,), dev)
    _check(tables["cont"], "cont", torch.float32,
           (2, cfg.max_n, 101, 128), dev)
    _check_max_n(cfg)
    packed = torch.empty(B, R, LW, dtype=torch.int32, device=dev)
    if B == 0 or R == 0:
        return packed
    ptr = [batch[k].data_ptr() for k in _INT8 + _INT32]
    with torch.cuda.device(dev):        # the launch goes to dev's context
        err = _build.entry("band_dp")(
            *ptr, tables["sub"].data_ptr(), tables["cont"].data_ptr(),
            packed.data_ptr(), B, R, A, cfg.r, cfg.max_n, cfg.inf,
            cfg.indel_start, cfg.indel_extend,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "band_dp")
    global launches
    launches += 1
    return packed


def occupancy(cfg: AlignConfig) -> int:
    """CTAs of K1 resident on one SM of the current card at its launch
    shape, from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    _check_max_n(cfg)
    n = _build.entry("band_dp", "npore_band_dp_occupancy")(cfg.max_n)
    if n < 0:
        raise RuntimeError(f"band_dp occupancy: CUDA error {-n}")
    return n


def _check_max_n(cfg: AlignConfig) -> None:
    if not 1 <= cfg.max_n <= 7:
        raise ValueError("band_dp keeps 8 rows of state: needs max_n <= 7")


def _check(x: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"band_dp: {name} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
