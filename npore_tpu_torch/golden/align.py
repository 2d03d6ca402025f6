"""Banded 5-state n-polymer alignment DP — executable NumPy specification.

Semantics follow the reference kernel exactly (reference: src/aln.pyx:379-787):

* The input CIGAR is reparameterized so every step advances one row (I) or
  one column (D) of the virtual (seq+1) x (ref+1) "A" matrix: X/=/M -> "DI".
* The DP runs in a banded "B" matrix indexed by anti-diagonal b_row =
  a_row + a_col and b_col = inss[b_row] - a_row + r: a band of width 2r+1
  centered on the original alignment path; b_col 0 and 2r are walls.
* Anti-diagonals are processed in chunks of max_b_rows (breaks shifted back
  one step so a D,I pair from an original match is never split); each chunk
  is an independent DP over re-sliced sequences with chunk-local n-polymer
  info, backtracked immediately.
* Five states per cell, each storing (VAL, TYP, RUN): MAT match/sub, INS/DEL
  affine indels, LEN/SHR n-polymer lengthen/shorten. LEN/SHR updates are
  scatter-style jumps of n rows/cols scored by the learned np_scores table.

All value arithmetic is float32, matching the reference's C float math.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..config import AlignConfig
from .npinfo import get_np_info, L, L_IDX

MAT, INS, LEN, DEL, SHR = 0, 1, 2, 3, 4
TYPES = 5
F32 = np.float32


def np_score(n: int, ref_np_len: int, indel_len: int,
             np_scores: np.ndarray, max_n: int) -> np.float32:
    """Penalty for changing an n-polymer's unit count (src/aln.pyx:255-274).

    Quirk kept for parity: callers pass max_l (=100) as the `max_n`
    parameter, so lengths clamp to max_l-1 = 99 and the n-validity check is
    effectively inert (src/aln.pyx:615,629,650,663).
    """
    if ref_np_len <= 0:
        return F32(100)
    if ref_np_len + indel_len < 0:
        return F32(100)
    if n < 1 or n > max_n:
        return F32(100)
    call_np_len = ref_np_len + indel_len
    if ref_np_len > max_n - 1:
        ref_np_len = max_n - 1
    if call_np_len > max_n - 1:
        call_np_len = max_n - 1
    return F32(np_scores[n - 1, ref_np_len, call_np_len])


def get_inss(cigar: str) -> np.ndarray:
    """Prefix counts of 'I' steps along the path (src/aln.pyx:279-292)."""
    steps = np.frombuffer(cigar.encode(), dtype=np.uint8) == ord("I")
    out = np.zeros(len(cigar) + 1, dtype=np.int64)
    np.cumsum(steps, out=out[1:])
    return out


def get_dels(cigar: str) -> np.ndarray:
    """Prefix counts of 'D' steps along the path (src/aln.pyx:296-311)."""
    steps = np.frombuffer(cigar.encode(), dtype=np.uint8) == ord("D")
    out = np.zeros(len(cigar) + 1, dtype=np.int64)
    np.cumsum(steps, out=out[1:])
    return out


def get_breaks(chunk_size: int, array_size: int, inss: np.ndarray,
               dels: np.ndarray) -> List[int]:
    """Chunk boundaries every chunk_size-1 anti-diagonals, shifted back one
    step if the boundary would split a D,I pair that was originally a single
    match move (src/aln.pyx:344-358)."""
    import math
    buf_len = 1 + math.ceil((array_size - 1) / (chunk_size - 1))
    breaks = [0] * buf_len
    for i in range(buf_len - 1):
        b = i * (chunk_size - 1)
        if i > 0 and inss[b + 1] == inss[b] + 1 and dels[b] == dels[b - 1] + 1:
            b -= 1
        breaks[i] = b
    breaks[buf_len - 1] = array_size - 1
    return breaks


def _match(a: np.ndarray, b: np.ndarray) -> bool:
    """Elementwise equality incl. lengths (src/aln.pyx:362-372)."""
    return len(a) == len(b) and bool(np.array_equal(a, b))


def align(full_ref: np.ndarray, full_seq: np.ndarray, cigar: str,
          sub_scores: np.ndarray, np_scores: np.ndarray,
          cfg: AlignConfig = AlignConfig(),
          errors: Optional[List[str]] = None) -> str:
    """Realign seq to ref within a band around the existing alignment.

    full_ref / full_seq: int-encoded (uint8) reference window and query.
    cigar: extended CIGAR of the current alignment (ops over =XMIDS space,
    clips already stripped). Returns the new extended CIGAR over '=XID'.
    """
    indel_start = F32(cfg.indel_start)
    indel_extend = F32(cfg.indel_extend)
    max_b_rows = cfg.max_b_rows
    r = cfg.r
    max_l = cfg.max_l
    max_n = cfg.max_n
    INF = 100  # per-step penalty ceiling (src/aln.pyx:426-428)

    cigar = cigar.replace("X", "DI").replace("=", "DI").replace("M", "DI")
    inss = get_inss(cigar)
    dels = get_dels(cigar)
    breaks = get_breaks(max_b_rows, len(full_seq) + len(full_ref) + 1, inss, dels)

    a_rows = len(full_seq) + 1
    a_cols = len(full_ref) + 1
    b_cols = 2 * r + 1

    # (VAL, TYP, RUN) per state; RUN kept integral, VAL float32
    val = np.zeros((TYPES, max_b_rows + 1, b_cols), dtype=np.float32)
    typ_m = np.zeros((TYPES, max_b_rows + 1, b_cols), dtype=np.int32)
    run_m = np.zeros((TYPES, max_b_rows + 1, b_cols), dtype=np.int64)

    zeros = np.zeros(max_n, dtype=np.int32)
    full_aln = []

    def b2a_row(b_row_g: int, b_col: int) -> int:
        return int(inss[b_row_g]) + r - b_col

    def b2a_col(b_row_g: int, b_col: int) -> int:
        return int(dels[b_row_g]) - r + b_col

    def a2b_col(a_row: int, a_col: int) -> int:
        return int(inss[a_row + a_col]) - a_row + r

    for brk_idx in range(len(breaks) - 1):
        brk = breaks[brk_idx]
        next_brk = breaks[brk_idx + 1]
        b_rows = next_brk - brk + 1
        val.fill(0)
        typ_m.fill(0)
        run_m.fill(0)

        ins_brk = int(inss[brk])
        del_brk = int(dels[brk])
        ins_next = int(inss[next_brk])
        del_next = int(dels[next_brk])

        # chunk-local slices with one base of n-polymer lookahead
        ref = full_ref[del_brk:del_next + 1]
        seq = full_seq[ins_brk:ins_next + 1]
        np_info = get_np_info(ref, max_n, max_l)
        np_info_seq = get_np_info(seq, max_n, max_l)

        # initialize LEN/SHR with penalize-by-distance invalid states
        # (src/aln.pyx:465-478)
        for b_row in range(b_rows):
            g = b_row + brk
            for b_col in range(b_cols):
                a_row = b2a_row(g, b_col)
                a_col = b2a_col(g, b_col)
                if (a_row < ins_brk or a_col < del_brk or a_row > ins_next
                        or a_col > del_next or b_col == 0 or b_col == 2 * r):
                    continue
                v = F32(INF * (a_row - ins_brk + a_col - del_brk))
                for t in (LEN, SHR):
                    val[t, b_row, b_col] = v
                    typ_m[t, b_row, b_col] = MAT
                    run_m[t, b_row, b_col] = 0

        # fill (src/aln.pyx:481-667)
        for b_row in range(b_rows):
            g = b_row + brk
            for b_col in range(b_cols):
                a_row = b2a_row(g, b_col)
                a_col = b2a_col(g, b_col)
                if (a_row < ins_brk or a_col < del_brk
                        or a_row > ins_next or a_col > del_next):
                    continue
                if b_col == 0 or b_col == 2 * r:  # band walls
                    for t in range(TYPES):
                        val[t, b_row, b_col] = F32(INF * (b_row + 1))
                        typ_m[t, b_row, b_col] = MAT
                        run_m[t, b_row, b_col] = 0
                    continue

                b_top_row = (a_row - 1) + a_col - brk
                b_top_col = a2b_col(a_row - 1, a_col)
                b_left_row = a_row + (a_col - 1) - brk
                b_left_col = a2b_col(a_row, a_col - 1)
                b_diag_row = (a_row - 1) + (a_col - 1) - brk
                b_diag_col = a2b_col(a_row - 1, a_col - 1)
                ref_idx = a_col - del_brk - 1
                seq_idx = a_row - ins_brk - 1

                # n-polymer info at the next ref/seq base (src/aln.pyx:509-521)
                if a_col >= a_cols - 1:
                    l = zeros
                    l_idx = zeros
                else:
                    l = np_info[ref_idx + 1, L, :]
                    l_idx = np_info[ref_idx + 1, L_IDX, :]
                if a_row >= a_rows - 1:
                    l_seq = zeros
                    l_idx_seq = zeros
                else:
                    l_seq = np_info_seq[seq_idx + 1, L, :]
                    l_idx_seq = np_info_seq[seq_idx + 1, L_IDX, :]

                # --- INS (src/aln.pyx:524-543) ---
                if a_row == ins_brk:
                    val[INS, b_row, b_col] = F32(INF * (a_col - del_brk + 1))
                    typ_m[INS, b_row, b_col] = DEL
                    run_m[INS, b_row, b_col] = a_col - del_brk
                else:
                    v1 = val[MAT, b_top_row, b_top_col] + indel_start
                    val[INS, b_row, b_col] = v1
                    typ_m[INS, b_row, b_col] = INS
                    run_m[INS, b_row, b_col] = 1
                    v2 = val[INS, b_top_row, b_top_col] + indel_extend
                    if v2 < v1:
                        run = 1 if a_row == ins_brk + 1 \
                            else int(run_m[INS, b_top_row, b_top_col]) + 1
                        val[INS, b_row, b_col] = v2
                        typ_m[INS, b_row, b_col] = INS
                        run_m[INS, b_row, b_col] = run

                # --- DEL (src/aln.pyx:546-565) ---
                if a_col == del_brk:
                    val[DEL, b_row, b_col] = F32(INF * (a_row - ins_brk + 1))
                    typ_m[DEL, b_row, b_col] = INS
                    run_m[DEL, b_row, b_col] = a_row - ins_brk
                else:
                    v1 = val[MAT, b_left_row, b_left_col] + indel_start
                    val[DEL, b_row, b_col] = v1
                    typ_m[DEL, b_row, b_col] = DEL
                    run_m[DEL, b_row, b_col] = 1
                    v2 = val[DEL, b_left_row, b_left_col] + indel_extend
                    if v2 < v1:
                        run = 1 if a_col == del_brk + 1 \
                            else int(run_m[DEL, b_left_row, b_left_col]) + 1
                        val[DEL, b_row, b_col] = v2
                        typ_m[DEL, b_row, b_col] = DEL
                        run_m[DEL, b_row, b_col] = run

                # --- MAT (src/aln.pyx:568-592) ---
                if a_row > ins_brk and a_col > del_brk:
                    if typ_m[MAT, b_diag_row, b_diag_col] == MAT:
                        run = int(run_m[MAT, b_diag_row, b_diag_col]) + 1
                    else:
                        run = 1
                    v1 = val[MAT, b_diag_row, b_diag_col] + \
                        F32(sub_scores[int(seq[seq_idx]), int(ref[ref_idx])])
                    val[MAT, b_row, b_col] = v1
                    typ_m[MAT, b_row, b_col] = MAT
                    run_m[MAT, b_row, b_col] = run
                else:
                    v1 = val[DEL, b_row, b_col] + F32(INF)

                for t in (INS, LEN, DEL, SHR):  # end INDEL
                    v2 = val[t, b_row, b_col]
                    if v2 < v1:
                        v1 = v2
                        val[MAT, b_row, b_col] = v2
                        typ_m[MAT, b_row, b_col] = t
                        run_m[MAT, b_row, b_col] = run_m[t, b_row, b_col]

                # --- LEN: lengthen a seq-side n-polymer (src/aln.pyx:595-633) ---
                if a_row == ins_brk:
                    val[LEN, b_row, b_col] = F32(INF * (a_col - del_brk))
                    typ_m[LEN, b_row, b_col] = DEL
                    run_m[LEN, b_row, b_col] = a_col - del_brk

                for n in range(1, max_n + 1):
                    ni = n - 1
                    if (l[ni] == 0 or l_seq[ni] == 0 or l_idx[ni] != 0
                            or not _match(seq[seq_idx + 1:seq_idx + 1 + n],
                                          ref[ref_idx + 1:ref_idx + 1 + n])):
                        continue
                    if a_row + n <= ins_next:
                        nd_row = (a_row + n) + a_col - brk
                        nd_col = a2b_col(a_row + n, a_col)
                        if nd_col > 0:  # target stays inside the band
                            if l_idx_seq[ni] == 0:  # start insertion
                                v1 = val[MAT, b_row, b_col] + \
                                    np_score(n, int(l[ni]), 1, np_scores, max_l)
                                if v1 < val[LEN, nd_row, nd_col]:
                                    val[LEN, nd_row, nd_col] = v1
                                    typ_m[LEN, nd_row, nd_col] = LEN
                                    run_m[LEN, nd_row, nd_col] = n
                            else:  # continue insertion from the run anchor
                                run = int(run_m[LEN, b_row, b_col])
                                if run > 0 and a_row - run >= ins_brk:
                                    ru_row = (a_row - run) + a_col - brk
                                    ru_col = a2b_col(a_row - run, a_col)
                                    if ru_col < 2 * r:
                                        v1 = val[MAT, ru_row, ru_col] + \
                                            np_score(n, int(l[ni]), run // n + 1,
                                                     np_scores, max_l)
                                        if v1 < val[LEN, nd_row, nd_col]:
                                            val[LEN, nd_row, nd_col] = v1
                                            typ_m[LEN, nd_row, nd_col] = LEN
                                            run_m[LEN, nd_row, nd_col] = run + n

                # --- SHR: shorten a ref-side n-polymer (src/aln.pyx:636-667) ---
                if a_col == del_brk:
                    val[SHR, b_row, b_col] = F32(INF * (a_row - ins_brk))
                    typ_m[SHR, b_row, b_col] = INS
                    run_m[SHR, b_row, b_col] = a_row - ins_brk

                for n in range(1, max_n + 1):
                    ni = n - 1
                    if l[ni] == 0:
                        continue
                    if a_col + n <= del_next:
                        nr_row = a_row + (a_col + n) - brk
                        nr_col = a2b_col(a_row, a_col + n)
                        if nr_col < 2 * r:
                            if l_idx[ni] == 0:  # start deletion
                                v1 = val[MAT, b_row, b_col] + \
                                    np_score(n, int(l[ni]), -1, np_scores, max_l)
                                if v1 < val[SHR, nr_row, nr_col]:
                                    val[SHR, nr_row, nr_col] = v1
                                    typ_m[SHR, nr_row, nr_col] = SHR
                                    run_m[SHR, nr_row, nr_col] = n
                            else:  # continue deletion
                                run = int(run_m[SHR, b_row, b_col])
                                if run > 0 and a_col - run >= del_brk:
                                    rl_row = a_row + (a_col - run) - brk
                                    rl_col = a2b_col(a_row, a_col - run)
                                    if rl_col > 0:
                                        v1 = val[MAT, rl_row, rl_col] + \
                                            np_score(n, int(l[ni]), -(run // n) - 1,
                                                     np_scores, max_l)
                                        if v1 < val[SHR, nr_row, nr_col]:
                                            val[SHR, nr_row, nr_col] = v1
                                            typ_m[SHR, nr_row, nr_col] = SHR
                                            run_m[SHR, nr_row, nr_col] = run + n

        # backtrack this chunk (src/aln.pyx:670-742)
        a_row = ins_next
        a_col = del_next
        aln = []
        while a_row > ins_brk or a_col > del_brk:
            b_row = a_row + a_col - brk
            b_col = a2b_col(a_row, a_col)
            t = int(typ_m[MAT, b_row, b_col])
            run = int(run_m[MAT, b_row, b_col])

            if a_row < 0 or a_col < 0 or run < 1:
                msg = (f"traceback error @ A:({a_row},{a_col}) "
                       f"B:({b_row},{b_col}) typ {t} run {run}")
                if errors is not None:
                    errors.append(msg)
                break

            if t == LEN or t == INS:
                aln.append("I" * run)
                a_row -= run
            elif t == SHR or t == DEL:
                aln.append("D" * run)
                a_col -= run
            elif t == MAT:
                ops = []
                for _ in range(run):
                    a_row -= 1
                    a_col -= 1
                    ops.append("=" if ref[a_col - del_brk] == seq[a_row - ins_brk]
                               else "X")
                aln.append("".join(ops))
            else:
                if errors is not None:
                    errors.append(f"unknown type {t}")
                break

        full_aln.append("".join(aln)[::-1])

    return "".join(full_aln)
