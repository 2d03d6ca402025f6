"""MAT planes written along a chosen path, for traceback tests.

``path_group`` takes extended CIGARs over '=XID' and builds, for each, a
window whose bases agree with its CIGAR ('=' the same base, 'X' another)
and whose planes are zero except for one ``typ | run << 3`` cell per run of
the CIGAR, at the cell the traceback reads when it reaches that run. A
traceback over these planes walks the CIGAR back exactly; a test corrupts
a cell (``PathWindow.cells``) to drive a bail. The group has the layout of
``engine/windows.pack_group`` in the arrays the traceback reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import groupby
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..engine.windows import PADL, PADR, path_inss
from ..ops.traceback import DEL, INS, LEN, LW, MAT, SHR


@dataclass
class PathWindow:
    cigar: str
    n_ins: int
    n_del: int
    seq: np.ndarray            # int8 (n_ins + 1,): bases and one lookahead
    ref: np.ndarray            # int8 (n_del + 1,)
    inss_local: np.ndarray     # int32 (n_ins + n_del + 1,)
    cells: List[Tuple[int, int, int, int]]   # (t, lane, typ, run), walk order


def runs(cigar: str) -> List[Tuple[str, int]]:
    """Maximal runs of a CIGAR, '=' and 'X' together as 'M'."""
    return [(op, len(list(g))) for op, g in groupby(
        cigar, key=lambda c: "M" if c in "=X" else c)]


def path_window(cigar: str, r: int, rng: np.random.Generator) -> PathWindow:
    """Bases and path cells of one window; I runs take type INS or LEN and
    D runs DEL or SHR at random."""
    seq, ref = [], []
    for op in cigar:
        b = int(rng.integers(0, 4))
        if op in "=X":
            seq.append(b)
            ref.append(b if op == "=" else (b + int(rng.integers(1, 4))) % 4)
        elif op == "I":
            seq.append(b)
        else:
            ref.append(b)
    seq.append(int(rng.integers(0, 4)))
    ref.append(int(rng.integers(0, 4)))
    inss = path_inss(cigar)
    arow, acol = len(seq) - 1, len(ref) - 1
    cells = []
    for op, n in reversed(runs(cigar)):
        t = arow + acol
        lane = int(inss[t]) - arow + r
        if op == "I":
            typ = (INS, LEN)[int(rng.integers(0, 2))]
            arow -= n
        elif op == "D":
            typ = (DEL, SHR)[int(rng.integers(0, 2))]
            acol -= n
        else:
            typ = MAT
            arow -= n
            acol -= n
        cells.append((t, lane, typ, n))
    return PathWindow(cigar, len(seq) - 1, len(ref) - 1,
                      np.array(seq, np.int8), np.array(ref, np.int8),
                      inss.astype(np.int32), cells)


def path_group(cigars: Sequence[str], r: int = 30, seed: int = 0
               ) -> Tuple[List[PathWindow], Dict[str, torch.Tensor],
                          torch.Tensor]:
    """Windows of ``cigars``, their group batch (``inss``, ``seqbuf``,
    ``refbuf``, ``n_ins``, ``n_del``) and packed planes (B, R, 64) int32,
    on the CPU, R the longest path's rows."""
    rng = np.random.default_rng(seed)
    wins = [path_window(c, r, rng) for c in cigars]
    B = len(wins)
    R = max(len(w.inss_local) for w in wins)
    A = PADL + R + PADR
    inss = np.zeros((B, R + 8), np.int32)
    seqbuf = np.zeros((B, A), np.int8)
    refbuf = np.zeros((B, A), np.int8)
    packed = np.zeros((B, R, LW), np.int32)
    for i, w in enumerate(wins):
        rows = len(w.inss_local)
        inss[i, 8:8 + rows] = w.inss_local
        inss[i, 8 + rows:] = w.inss_local[-1]
        seqbuf[i, PADL:PADL + len(w.seq)] = w.seq
        refbuf[i, PADL:PADL + len(w.ref)] = w.ref
        for t, lane, typ, n in w.cells:
            packed[i, t, lane] = typ | n << 3
    batch = {"inss": inss, "seqbuf": seqbuf, "refbuf": refbuf,
             "n_ins": np.array([w.n_ins for w in wins], np.int32),
             "n_del": np.array([w.n_del for w in wins], np.int32)}
    return (wins, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.from_numpy(packed))


def random_cigar(rng: np.random.Generator, n_ops: int) -> str:
    """A CIGAR of ``n_ops`` ops, 3% D, 5% I and 3% X as ``synth.make_read``
    draws them, starting and ending on a match."""
    u = rng.random(n_ops)
    ops = np.where(u < 0.03, "D", np.where(
        u < 0.08, "I", np.where(u < 0.11, "X", "=")))
    ops[0] = ops[-1] = "="
    return "".join(ops)
