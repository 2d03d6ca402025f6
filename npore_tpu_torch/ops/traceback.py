"""Traceback over the packed MAT planes in plain PyTorch.

A lockstep backward sweep, vectorised over windows, with the semantics of
``npore_tpu/ops/traceback.py::traceback_window`` (reference:
src/aln.pyx:670-742) and the bail rules of the TPU traceback kernel
(``npore_tpu/ops/pallas_dp.py::tb_kernel``). From (n_ins, n_del) each step
reads ``typ | run << 3`` at (t = arow + acol, lane = inss[t] - arow + r):
INS/LEN runs emit 'I', DEL/SHR runs 'D', MAT runs '='/'X' one row at a
time by comparing the bases. A window bails on a lane outside the band,
run < 1, an unknown type, or a step past row or column 0; a bailing step
emits nothing. It is the oracle of the CUDA kernel (``ops/tb_cuda.py``).

Output layout, shared with the kernel: one uint8 buffer holding
``meta (B, 2) int32`` = (CIGAR length, bail) followed by ``cig (B, L)``,
L = max(n_ins + n_del, 1). Window w's forward extended CIGAR is right-
aligned at column n_ins + n_del: ``cig[w, end - len : end]``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import AlignConfig

MAT, INS, LEN, DEL, SHR = 0, 1, 2, 3, 4
PADL = 80
LW = 64
OP_EQ, OP_X, OP_I, OP_D = (ord(c) for c in "=XID")


class TbOut(NamedTuple):
    buf: torch.Tensor       # (8 * B + B * L,) uint8: everything below
    meta: torch.Tensor      # (B, 2) int32: CIGAR length, bail flag
    cig: torch.Tensor       # (B, L) uint8


def alloc_out(batch: Dict[str, torch.Tensor], L: Optional[int] = None
              ) -> TbOut:
    """Zeroed output buffer for the windows of ``batch``; ``L`` (at least
    the largest n_ins + n_del) saves reading it back from the device."""
    ends = batch["n_ins"].long() + batch["n_del"].long()
    B = ends.shape[0]
    if L is None:
        L = max(int(ends.max()) if B else 1, 1)
    buf = torch.zeros(8 * B + B * L, dtype=torch.uint8,
                      device=ends.device)
    return TbOut(buf, buf[:8 * B].view(torch.int32).view(B, 2),
                 buf[8 * B:].view(B, L))


def traceback(packed: torch.Tensor, batch: Dict[str, torch.Tensor],
              cfg: AlignConfig, L: Optional[int] = None) -> TbOut:
    """Per-window extended CIGAR bytes and bail flags from the planes."""
    out = alloc_out(batch, L)
    B, L = out.cig.shape
    dev = packed.device
    inss = batch["inss"].long()
    seq, ref = batch["seqbuf"].long(), batch["refbuf"].long()
    A = seq.shape[1]
    R = packed.shape[1]
    n_ins, n_del = batch["n_ins"].long(), batch["n_del"].long()
    rows = torch.arange(B, device=dev)
    arow, acol = n_ins.clone(), n_del.clone()
    pend = torch.zeros_like(arow)
    bail = torch.zeros(B, dtype=torch.bool, device=dev)
    done = (arow <= 0) & (acol <= 0)
    T = int((n_ins + n_del).max()) + 1 if B else 0
    ops = torch.zeros(B, max(T, 1), dtype=torch.uint8, device=dev)
    cnts = torch.zeros(B, max(T, 1), dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        active = ~done & (arow + acol == t)
        fresh = active & (pend == 0)
        lane = inss[:, 8 + min(t, R - 1)] - arow + cfg.r
        lane_ok = (lane >= 0) & (lane < LW) & (t < R)
        pk = packed[rows, min(t, R - 1), lane.clamp(0, LW - 1)].long()
        typ, run = pk & 7, pk >> 3
        bad = fresh & (~lane_ok | (run < 1) | (typ > SHR))
        ok = fresh & ~bad
        is_i = ok & ((typ == INS) | (typ == LEN))
        is_d = ok & ((typ == DEL) | (typ == SHR))
        bad = bad | (is_i & (run > arow)) | (is_d & (run > acol))
        is_i = is_i & ~bad
        is_d = is_d & ~bad
        pend = torch.where(ok & (typ == MAT), run, pend)
        in_m = active & ~bad & (pend > 0)
        bad = bad | (in_m & ((arow < 1) | (acol < 1)))
        in_m = in_m & ~bad
        s = seq.gather(1, (PADL + arow - 1).clamp(0, A - 1)[:, None])[:, 0]
        f = ref.gather(1, (PADL + acol - 1).clamp(0, A - 1)[:, None])[:, 0]
        op = torch.where(in_m, torch.where(s == f, OP_EQ, OP_X), 0)
        op = torch.where(is_i, OP_I, torch.where(is_d, OP_D, op))
        ops[:, t] = op.to(torch.uint8)
        cnts[:, t] = torch.where(in_m, 1, torch.where(is_i | is_d, run, 0))
        arow = torch.where(in_m, arow - 1, torch.where(is_i, arow - run, arow))
        acol = torch.where(in_m, acol - 1, torch.where(is_d, acol - run, acol))
        pend = torch.where(in_m, pend - 1, pend)
        bail = bail | bad
        done = done | ((arow <= 0) & (acol <= 0)) | bail
    bail = bail | ~done

    # expand the per-row (op, count) slots in forward (ascending t) order
    lens = cnts.sum(dim=1)
    mask = cnts > 0
    counts = cnts[mask]
    chars = torch.repeat_interleave(ops[mask], counts)
    wid = torch.repeat_interleave(rows[:, None].expand_as(mask)[mask], counts)
    first = torch.cumsum(lens, 0) - lens
    pos = torch.arange(chars.numel(), device=dev) - first[wid]
    col = (n_ins + n_del - lens)[wid] + pos
    out.cig[wid, col] = chars
    out.meta[:, 0] = lens.to(torch.int32)
    out.meta[:, 1] = bail.to(torch.int32)
    return out


def decode(meta: np.ndarray, cig: np.ndarray, ends: np.ndarray
           ) -> Tuple[List[str], np.ndarray]:
    """Host side: CIGAR strings and bail flags from a TbOut's ``meta`` and
    ``cig`` (as numpy) and the windows' ends (n_ins + n_del)."""
    cigs = [cig[w, e - n:e].tobytes().decode("ascii")
            for w, (e, n) in enumerate(zip(ends, meta[:, 0]))]
    return cigs, meta[:, 1].astype(bool)
