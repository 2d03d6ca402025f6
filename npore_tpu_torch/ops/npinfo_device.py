"""The n-polymer scan as batched tensor operations (the plain version of K4).

The counterpart of ``npore_tpu/ops/npinfo_device.py::np_info_device``, the
scan the JAX engine runs on the accelerator ahead of the DP. It is an exact
reformulation of the sequential reference scanner (``golden/npinfo.py``,
reference src/aln.pyx:179-251):

* for each period n, the run of self-similarity matches
  ``seq[p] == seq[p + n]`` starting at p gives p's raw unit count;
* runs partition each residue class (mod n) into chains, in which every
  start covers the chain up to its end, so "start q covers p" is "q is a
  chain predecessor of p";
* the final writer of p is the LAST qualifying chain predecessor with raw
  length > max_l if there is one (those always overwrite the clamped
  stored value), otherwise the FIRST qualifying chain predecessor (later
  starts of a chain have smaller raw lengths and never overwrite);
* so L = min(raw[w], max_l) and L_IDX = (p - w) / n for the winner w.

Qualification at period n compares raw * n with the finished, clamped L of
every shorter period at the same start, so the periods run in order.
A run stops at its row's real length, as the reference scans the window's
slice: zero padding alone is not enough, since an N (0) inside the row
matches the padding (a row A N A N A would gain a third unit). Without
``lengths`` every row runs to P, as in the JAX function. Planes are zero
at and past a row's length.

``np_info_device`` returns full L_IDX planes (the JAX function returns only
``L_IDX == 0``); ``npinfo_cuda.fill_planes`` writes them, as the engine's
int8 planes, into a group buffer.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _segscan(first: torch.Tensor, last: torch.Tensor, keep: torch.Tensor,
             K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented running min of ``first`` and max of ``last`` along the last
    axis; a segment starts where ``keep`` is False. Values lie in
    [-1, K - 1], so offsetting each segment by its id times K keeps every
    earlier segment out of the running min (max) of a later one."""
    seg = torch.cumsum((~keep).to(torch.int64), dim=-1) * K
    f = torch.cummin(first - seg, dim=-1).values + seg
    lt = torch.cummax(last + seg, dim=-1).values - seg
    return f, lt


def np_info_device(seq: torch.Tensor, max_n: int = 6, max_l: int = 100,
                   lengths: torch.Tensor = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """seq: (B, P) integer bases, 0 = 'N'; lengths: (B,) each row's real
    length (P if None). Returns (L, L_IDX): (B, max_n, P) int32, L clamped
    to max_l."""
    seq = seq.to(torch.int64)
    B, P = seq.shape
    dev = seq.device
    pos = torch.arange(P, device=dev)
    NONE = P                     # "no start" in the running min
    room = P - pos if lengths is None else \
        lengths.to(dev, torch.int64)[:, None] - pos     # bases from p on

    # run lengths of all periods from one reverse cummin of the next
    # mismatch at or after p; a match needs p + n inside the row
    m = torch.zeros(B, max_n, P, dtype=torch.bool, device=dev)
    for n in range(1, min(max_n, P - 1) + 1):
        m[:, n - 1, :P - n] = ((seq[:, :-n] == seq[:, n:])
                               & (room[..., :-n] > n))
    nf = torch.where(m, P, pos).flip(-1).cummin(-1).values.flip(-1)
    t_all = nf - pos

    Ls, Is = [], []
    stored = torch.zeros(B, P, dtype=torch.int64, device=dev)  # max L*n2
    for n in range(1, max_n + 1):
        t = t_all[:, n - 1]
        units = t // n
        raw = torch.where(units > 0, units + 1, 0)
        qual = (raw > 2) & (seq != 0) & (raw * n > stored)
        # p - n links to p when its run spans at least n more
        link = torch.zeros(B, P, dtype=torch.bool, device=dev)
        link[:, n:] = t[:, :-n] >= n

        # residue classes on their own axis, the scan along the class
        pad = (-P) % n
        Q = (P + pad) // n

        def classes(x, fill):
            x = torch.nn.functional.pad(x, (0, pad), value=fill)
            return x.view(B, Q, n).transpose(1, 2)

        def declass(x):
            return x.transpose(1, 2).reshape(B, Q * n)[:, :P]

        first = torch.where(qual, pos, NONE)
        last = torch.where(qual & (raw > max_l), pos, -1)
        f, lt = _segscan(classes(first, NONE), classes(last, -1),
                         classes(link, False), P + 2)
        f, lt = declass(f), declass(lt)
        covered = f < NONE
        win = torch.where(lt >= 0, lt, torch.where(covered, f, pos))
        raw_w = torch.gather(raw, 1, win)
        L = torch.where(covered, torch.clamp(raw_w, max=max_l), 0)
        Li = torch.where(covered, (pos - win) // n, 0)
        stored = torch.maximum(stored, L * n)
        Ls.append(L.to(torch.int32))
        Is.append(Li.to(torch.int32))
    return torch.stack(Ls, 1), torch.stack(Is, 1)
