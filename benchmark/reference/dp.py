"""The banded 5-state n-polymer DP and its traceback in plain PyTorch: the
benchmark's reference for what the port's kernels compute.

A frozen copy of the port's plain versions (``engine/windows.py``'s window
split, ``ops/band_dp.py``, ``ops/traceback.py``; reference src/aln.pyx:
344-358, 379-742), with one change that leaves every value as it was: the
six n-polymer periods' LEN and SHR candidates are taken in one step (the
plain version loops over them, keeping a candidate that is strictly below
the best so far in the order n = max_n .. 1, which is the first of the
minima in that order, and so ``min`` over the periods with the first index
kept). ``dtype`` sets the precision of the scores (float32 as the
configuration states; the control runs it lower).

Semantics: an alignment's CIGAR, rewritten so that every step is one row
(I) or one column (D), sets anti-diagonal rows; the band is 2r+1 cells
around the path; rows are cut into windows of ``max_b_rows`` anti-diagonals
(a break moved back one row where it would split a D,I pair), each window
an independent DP re-anchored on the path. States MAT, INS, LEN, DEL, SHR
keep (value, type, run); values are float adds with strict ``<`` selects
in that state order; LEN/SHR jump n rows or columns scored by the
n-polymer tables.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .npinfo import np_info_rows

MAT, INS, LEN, DEL, SHR = 0, 1, 2, 3, 4
LW = 64          # lanes: the band padded to 64 (2r+1 <= 64)
PADL, PADR = 80, 40
KDIM = 128
NL = 101
OP_EQ, OP_X, OP_I, OP_D = (ord(c) for c in "=XID")

_IS_M = np.zeros(256, dtype=bool)
for _c in "MX=":
    _IS_M[ord(_c)] = True


@dataclass(frozen=True)
class AlignParams:
    max_n: int = 6
    max_l: int = 100
    r: int = 30
    max_b_rows: int = 20000
    indel_start: float = 5.0
    indel_extend: float = 1.0
    inf: float = 100.0


@dataclass
class Window:
    key: Tuple[int, int]        # (alignment, chunk)
    b_rows: int
    n_ins: int
    n_del: int
    seq: np.ndarray
    ref: np.ndarray
    inss_local: np.ndarray
    ref_guard: int
    seq_guard: int


def path_inss(cigar: str) -> np.ndarray:
    """Prefix counts of I steps along the path, each M/X/= a D then an I."""
    raw = np.frombuffer(cigar.encode("ascii"), dtype=np.uint8)
    m = _IS_M[raw]
    sizes = m.astype(np.int64) + 1
    ends = np.cumsum(sizes)
    n2 = int(ends[-1]) if len(ends) else 0
    starts = ends - sizes
    is_i = np.zeros(n2, dtype=bool)
    is_i[starts[m] + 1] = True
    is_i[starts[raw == ord("I")]] = True
    inss = np.zeros(n2 + 1, dtype=np.int64)
    np.cumsum(is_i, out=inss[1:])
    return inss


def get_breaks(chunk_size: int, array_size: int, inss: np.ndarray,
               dels: np.ndarray) -> List[int]:
    buf_len = 1 + math.ceil((array_size - 1) / (chunk_size - 1))
    breaks = [0] * buf_len
    for i in range(buf_len - 1):
        b = i * (chunk_size - 1)
        if i > 0 and inss[b + 1] == inss[b] + 1 and dels[b] == dels[b - 1] + 1:
            b -= 1
        breaks[i] = b
    breaks[buf_len - 1] = array_size - 1
    return breaks


def build_windows(full_ref: np.ndarray, full_seq: np.ndarray, cigar: str,
                  p: AlignParams, aln_idx: int) -> List[Window]:
    inss = path_inss(cigar)
    dels = np.arange(len(inss), dtype=np.int64) - inss
    breaks = get_breaks(p.max_b_rows, len(full_seq) + len(full_ref) + 1,
                        inss, dels)
    out = []
    for ci in range(len(breaks) - 1):
        brk, nxt = breaks[ci], breaks[ci + 1]
        ib, db = int(inss[brk]), int(dels[brk])
        inx, dnx = int(inss[nxt]), int(dels[nxt])
        out.append(Window(
            key=(aln_idx, ci), b_rows=nxt - brk + 1,
            n_ins=inx - ib, n_del=dnx - db,
            seq=np.asarray(full_seq[ib:inx + 1], dtype=np.int8),
            ref=np.asarray(full_ref[db:dnx + 1], dtype=np.int8),
            inss_local=(inss[brk:nxt + 1] - ib).astype(np.int32),
            ref_guard=len(full_ref) - db, seq_guard=len(full_seq) - ib))
    return out


def pack(windows: Sequence[Window], p: AlignParams, device,
         chunk: int = 256) -> Dict[str, torch.Tensor]:
    """The windows padded and stacked, on ``device``, with the n-polymer
    planes of each window's slices (``npinfo.np_info_rows``, ``chunk``
    windows at a time)."""
    B = len(windows)
    R = max(w.b_rows for w in windows)
    A = PADL + R + PADR
    n = p.max_n
    seq = np.zeros((B, A), np.int8)
    ref = np.zeros((B, A), np.int8)
    inss = np.zeros((B, R + 8), np.int32)
    scal = {k: np.zeros(B, np.int32)
            for k in ("b_rows", "n_ins", "n_del", "ref_guard", "seq_guard")}
    for i, w in enumerate(windows):
        seq[i, PADL:PADL + len(w.seq)] = w.seq
        ref[i, PADL:PADL + len(w.ref)] = w.ref
        inss[i, 8:8 + w.b_rows] = w.inss_local
        inss[i, 8 + w.b_rows:] = w.inss_local[-1]
        for k in scal:
            scal[k][i] = getattr(w, k)
    out = {k: torch.from_numpy(v).to(device) for k, v in
           {"seqbuf": seq, "refbuf": ref, "inss": inss, **scal}.items()}
    for side, name in (("seq", "seqbuf"), ("ref", "refbuf")):
        lens = torch.tensor([len(getattr(w, side)) for w in windows],
                            device=device)
        lp = torch.zeros(B, A, n, dtype=torch.int8, device=device)
        ip = torch.zeros(B, A, n, dtype=torch.int8, device=device)
        for lo in range(0, B, chunk):
            rows = out[name][lo:lo + chunk, PADL:A - PADR + 1]
            L, Li = np_info_rows(rows, lens[lo:lo + chunk], n, p.max_l)
            lp[lo:lo + chunk, PADL:A - PADR + 1] = L.transpose(1, 2).to(
                torch.int8)
            ip[lo:lo + chunk, PADL:A - PADR + 1] = Li.transpose(1, 2).to(
                torch.int8)
        out["l_" + side], out["lidx_" + side] = lp, ip
    return out


def _shift(x: torch.Tensor, off: torch.Tensor, lanes: torch.Tensor
           ) -> torch.Tensor:
    """out[..., c, j] = x[..., c, j + off[...]] with zero fill
    (|off| <= 8); ``off`` has x's shape without its last two axes."""
    ext = F.pad(x, (8, 8))
    idx = (8 + off[..., None] + lanes).clamp_(0, LW + 15)
    return ext.gather(-1, idx[..., None, :].expand(*x.shape[:-1], LW))


def run_rows(step, n: int, dev) -> None:
    """``step`` ``n`` times. On a card the steps after the first replay one
    captured CUDA graph: the same kernels, launched without the host's
    dispatch of each (the step keeps its row counter on the device)."""
    if n <= 0:
        return
    if dev.type != "cuda":
        for _ in range(n):
            step()
        return
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    if n == 1:
        return
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    for _ in range(n - 1):
        g.replay()
    torch.cuda.synchronize(dev)
    del g


def window_dp(batch: Dict[str, torch.Tensor], sub: torch.Tensor,
              cont: torch.Tensor, p: AlignParams,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The MAT planes ``typ | run << 3`` (B, R, LW) int32 of every window."""
    r, N = p.r, p.max_n
    inss = batch["inss"].long()
    dev = inss.device
    B, R = inss.shape[0], inss.shape[1] - 8
    INF = torch.tensor(p.inf, dtype=dtype, device=dev)
    istart = torch.tensor(p.indel_start, dtype=dtype, device=dev)
    iext = torch.tensor(p.indel_extend, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    sub_flat = sub.reshape(-1).to(dtype)
    cont = cont.reshape(-1).to(dtype)
    ncont = cont.numel()
    lanes = torch.arange(LW, device=dev)

    def col(name):
        return batch[name].long()[:, None]

    n_ins, n_del, b_rows = col("n_ins"), col("n_del"), col("b_rows")
    ref_guard, seq_guard = col("ref_guard"), col("seq_guard")
    seq = F.pad(batch["seqbuf"].long(), (0, LW))
    ref = F.pad(batch["refbuf"].long(), (0, LW))
    A = seq.shape[1]

    def planes(name):
        return F.pad(batch[name], (0, 0, 0, LW)).reshape(B, -1)

    l_seq, lidx_seq = planes("l_seq"), planes("lidx_seq")
    l_ref, lidx_ref = planes("l_ref"), planes("lidx_ref")
    ns = torch.arange(1, N + 1, device=dev)[None, :, None]      # (1, N, 1)
    nis = ns - 1

    def at(buf, pos):
        return buf.gather(1, (PADL + pos).clamp(0, A - 1).reshape(B, -1)
                          ).reshape(pos.shape)

    def at_plane(buf, pos, ni):
        flat = (PADL + pos).clamp(0, A - 1) * N + ni
        return buf.gather(1, flat.reshape(B, -1)).reshape(flat.shape).long()

    def cont_at(side, l, k):
        flat = ((side * N + nis) * NL + l) * KDIM + k
        return cont[flat.clamp(0, ncont - 1)]

    # the n-polymer match of the reference's slices (src/aln.pyx:362-372):
    # for period n and k < n, seq[arow - n + k] against ref[acol + k]
    kk = torch.arange(N, device=dev)
    sw_pick = (6 + kk[None, :] - ns[0]).clamp(0, 5)             # (N, N)
    k_pick = kk[None, :].expand(N, N)
    kk4 = kk[None, None, :, None]

    H = max(N, 2)
    Fh = torch.zeros(B, H, 5, LW, dtype=dtype, device=dev)      # row t-1-h
    Ih = torch.zeros(B, H, 10, LW, dtype=torch.int32, device=dev)
    planes_out = torch.zeros(B, R, LW, dtype=torch.int32, device=dev)
    wall = (lanes == 0) | (lanes == 2 * r)
    dseq = torch.arange(-6, 0, device=dev)[None, :, None]
    dref = torch.arange(-1, 6, device=dev)[None, :, None]
    zero = torch.zeros((), dtype=dtype, device=dev)

    t = torch.zeros((), dtype=torch.long, device=dev)

    def step():
        ii = inss.gather(1, (t + 8).expand(B, 1))
        arow = ii + r - lanes
        acol = (t - ii) - r + lanes
        in_range = ((arow >= 0) & (acol >= 0) & (arow <= n_ins)
                    & (acol <= n_del) & (t <= b_rows - 1))
        live = in_range & ~wall & (lanes < 2 * r + 1)
        first_row = arow == 0
        first_col = acol == 0

        sw = at(seq, arow[:, None, :] + dseq)      # seq[arow - 6 .. arow - 1]
        rw = at(ref, acol[:, None, :] + dref)      # ref[acol - 1 .. acol + 5]
        ref_zero = (acol >= ref_guard)[:, None]
        l_n = torch.where(ref_zero, 0, at_plane(l_ref, acol[:, None, :], nis))
        lidx_n = torch.where(ref_zero, 0,
                             at_plane(lidx_ref, acol[:, None, :], nis))
        src_col = acol[:, None, :] - ns
        rzs = src_col >= ref_guard[:, None]
        l_n2 = torch.where(rzs, 0, at_plane(l_ref, src_col, nis))
        lidx_n2 = torch.where(rzs, 0, at_plane(lidx_ref, src_col, nis))
        src_row = arow[:, None, :] - ns
        sg = src_row >= seq_guard[:, None]
        lseq = torch.where(sg, 0, at_plane(l_seq, src_row, nis))
        lidxseq = torch.where(sg, 0, at_plane(lidx_seq, src_row, nis))

        step1 = ii - inss.gather(1, (t + 7).expand(B, 1))
        Fp, Ip = Fh[:, 0], Ih[:, 0]

        # --- INS (src/aln.pyx:524-543) ---
        Ft = _shift(Fp[:, 0:4:3], (1 - step1)[:, 0], lanes)    # MAT, INS
        It = _shift(Ip[:, 8:9], (1 - step1)[:, 0], lanes).long()
        v1 = Ft[:, 0] + istart
        v2 = Ft[:, 1] + iext
        use2 = v2 < v1
        run2 = torch.where(arow == 1, 1, It[:, 0] + 1)
        ins_v = torch.where(use2, v2, v1)
        ins_r = torch.where(use2, run2, 1)
        ins_v = torch.where(first_row, (acol + 1).to(dtype) * INF, ins_v)
        ins_r = torch.where(first_row, acol, ins_r)

        # --- DEL (src/aln.pyx:546-565) ---
        Fl = _shift(Fp[:, 0:5:4], -step1[:, 0], lanes)        # MAT, DEL
        Il = _shift(Ip[:, 9:10], -step1[:, 0], lanes).long()
        v1 = Fl[:, 0] + istart
        v2 = Fl[:, 1] + iext
        use2 = v2 < v1
        run2 = torch.where(acol == 1, 1, Il[:, 0] + 1)
        del_v = torch.where(use2, v2, v1)
        del_r = torch.where(use2, run2, 1)
        del_v = torch.where(first_col, (arow + 1).to(dtype) * INF, del_v)
        del_r = torch.where(first_col, arow, del_r)

        # --- LEN / SHR, every period at once (src/aln.pyx:601-667) ---
        Fn, In = Fh[:, :N], Ih[:, :N]                  # row t - n
        dI = ii - inss.gather(1, (t + 8 - ns[0, :, 0]).expand(B, N))
        s_n = ns[0, :, 0] - dI
        Fs = _shift(Fn[:, :, 0:2], s_n, lanes)             # MAT, LEN anchor
        Is = _shift(In[:, :, 2:5], s_n, lanes).long()      # LEN run, lane, a
        src_lane = lanes + s_n[..., None]
        src_ok = ((arow[:, None] - ns >= 0) & (src_lane >= 1)
                  & (src_lane <= 2 * r - 1) & (t >= ns))
        lenA = torch.minimum((n_ins[..., None] + 1 - (arow[:, None] - ns)
                              ).clamp(min=0), ns)
        lenB = torch.minimum((n_del[..., None] + 1 - acol[:, None]
                              ).clamp(min=0), ns)
        eq = sw[:, :, None, :] == rw[:, None, 1:, :]       # (B, 6, 6, LW)
        same = eq[:, sw_pick, k_pick]                      # (B, N, N, LW)
        mok = (lenA == lenB) & (same | (kk4 >= lenA[:, :, None])).all(2)
        valid = (src_ok & (l_n > 0) & (lseq > 0) & (lidx_n == 0) & mok
                 & (lanes > 0))
        start = lidxseq == 0
        lenr_src, lenac_src, lenaa_src = Is[:, :, 0], Is[:, :, 1], Is[:, :, 2]
        cand_s = Fs[:, :, 0] + cont_at(0, l_n, 1)
        k_c = torch.div(lenr_src, ns, rounding_mode="floor") + 1
        cand_c = Fs[:, :, 1] + cont_at(0, l_n, k_c.clamp(max=KDIM - 1))
        cont_ok = (lenr_src > 0) & (lenaa_src >= 0) & (lenac_src < 2 * r)
        cand = torch.where(start, cand_s, torch.where(cont_ok, cand_c, inf))
        len_v0 = (arow + acol).to(dtype) * INF
        best, pick = torch.where(valid, cand, inf).flip(1).min(1)
        pick = (N - 1 - pick)[:, None]
        upd = best < len_v0

        def sel(x):
            return x.gather(1, pick)[:, 0]

        len_v = torch.where(upd, best, len_v0)
        len_r = torch.where(upd, sel(torch.where(start, ns, lenr_src + ns)), 0)
        len_av = torch.where(upd, sel(torch.where(start, Fs[:, :, 0],
                                                  Fs[:, :, 1])), 0)
        len_ac = torch.where(upd, sel(torch.where(start, src_lane,
                                                  lenac_src)), 0)
        len_aa = torch.where(upd, sel(torch.where(
            start, arow[:, None] - ns, lenaa_src)), 0)

        Fs = _shift(Fn[:, :, 0:3:2], -dI, lanes)           # MAT, SHR anchor
        Is = _shift(In[:, :, 5:8], -dI, lanes).long()      # SHR run, lane, a
        src_lane2 = lanes - dI[..., None]
        src_ok2 = ((acol[:, None] - ns >= 0) & (src_lane2 >= 1)
                   & (src_lane2 <= 2 * r - 1) & (t >= ns))
        valid2 = src_ok2 & (l_n2 > 0) & (lanes < 2 * r)
        start2 = lidx_n2 == 0
        shrr_src, shrac_src, shraa_src = Is[:, :, 0], Is[:, :, 1], Is[:, :, 2]
        cand_s2 = Fs[:, :, 0] + cont_at(1, l_n2, 1)
        k_c2 = torch.div(shrr_src, ns, rounding_mode="floor") + 1
        cand_c2 = Fs[:, :, 1] + cont_at(1, l_n2, k_c2.clamp(max=KDIM - 1))
        cont_ok2 = (shrr_src > 0) & (shraa_src >= 0) & (shrac_src > 0)
        cand2 = torch.where(start2, cand_s2,
                            torch.where(cont_ok2, cand_c2, inf))
        best2, pick = torch.where(valid2, cand2, inf).flip(1).min(1)
        pick = (N - 1 - pick)[:, None]
        upd2 = best2 < len_v0
        shr_v = torch.where(upd2, best2, len_v0)
        shr_r = torch.where(upd2, sel(torch.where(start2, ns, shrr_src + ns)),
                            0)
        shr_av = torch.where(upd2, sel(torch.where(start2, Fs[:, :, 0],
                                                   Fs[:, :, 1])), 0)
        shr_ac = torch.where(upd2, sel(torch.where(start2, src_lane2,
                                                   shrac_src)), 0)
        shr_aa = torch.where(upd2, sel(torch.where(
            start2, acol[:, None] - ns, shraa_src)), 0)

        # --- MAT (src/aln.pyx:568-592) ---
        dI2 = ii - inss.gather(1, (t + 6).expand(B, 1))
        Fd = _shift(Fh[:, 1, 0:1], (1 - dI2)[:, 0], lanes)
        Id = _shift(Ih[:, 1, 0:2], (1 - dI2)[:, 0], lanes).long()
        s_idx = (sw[:, 5] * 5 + rw[:, 0]).clamp(0, 24)
        can_diag = (arow > 0) & (acol > 0)
        run_diag = torch.where(Id[:, 0] == MAT, Id[:, 1] + 1, 1)
        md = Fd[:, 0] + sub_flat[s_idx]
        v1 = torch.where(can_diag, md, del_v + INF)
        mat_v = torch.where(can_diag, md, zero)
        mat_t = torch.zeros_like(arow)
        mat_r = torch.where(can_diag, run_diag, 0)
        for ti, tv, tr in ((INS, ins_v, ins_r), (LEN, len_v, len_r),
                           (DEL, del_v, del_r), (SHR, shr_v, shr_r)):
            u = tv < v1
            v1 = torch.where(u, tv, v1)
            mat_v = torch.where(u, tv, mat_v)
            mat_t = torch.where(u, ti, mat_t)
            mat_r = torch.where(u, tr, mat_r)

        # --- first-row LEN / first-col SHR runs, after the MAT reduce ---
        len_r = torch.where(first_row, acol, len_r)
        shr_r = torch.where(first_col, arow, shr_r)

        # --- walls and cells outside the window (src/aln.pyx:497-507) ---
        wall_in = wall & in_range
        keep = in_range & ~wall_in
        wall_v = (t + 1).to(dtype) * INF

        def fin_v(v):
            return torch.where(in_range, torch.where(wall_in, wall_v, v),
                               zero)

        def fin_r(rr):
            return torch.where(keep, rr, 0)

        mat_t = torch.where(keep, mat_t, MAT)
        dead = ~live
        Frow = torch.stack([fin_v(mat_v), torch.where(dead, zero, len_av),
                            torch.where(dead, zero, shr_av), fin_v(ins_v),
                            fin_v(del_v)], dim=1)
        Irow = torch.stack([mat_t, fin_r(mat_r), fin_r(len_r),
                            torch.where(dead, 0, len_ac),
                            torch.where(dead, 0, len_aa), fin_r(shr_r),
                            torch.where(dead, 0, shr_ac),
                            torch.where(dead, 0, shr_aa), fin_r(ins_r),
                            fin_r(del_r)], dim=1)
        Fh.copy_(torch.cat([Frow[:, None], Fh[:, :-1]], 1))
        Ih.copy_(torch.cat([Irow[:, None].to(torch.int32), Ih[:, :-1]], 1))
        planes_out.index_copy_(1, t.view(1), (mat_t | (Irow[:, 1] << 3))
                               .to(torch.int32)[:, None])
        t.add_(1)

    run_rows(step, R, dev)
    return planes_out


def traceback(packed: torch.Tensor, batch: Dict[str, torch.Tensor],
              p: AlignParams) -> Tuple[List[str], np.ndarray]:
    """Each window's extended '=XID' CIGAR and bail flag, walking the MAT
    planes back from (n_ins, n_del) in lockstep: INS/LEN runs emit I,
    DEL/SHR runs D, MAT runs '='/'X' a row at a time. A window bails on a
    lane outside the band, run < 1, an unknown type or a step past row or
    column 0."""
    dev = packed.device
    inss = batch["inss"].long()
    seq, ref = batch["seqbuf"].long(), batch["refbuf"].long()
    A = seq.shape[1]
    B, R = packed.shape[0], packed.shape[1]
    n_ins, n_del = batch["n_ins"].long(), batch["n_del"].long()
    rows = torch.arange(B, device=dev)
    arow, acol = n_ins.clone(), n_del.clone()
    pend = torch.zeros_like(arow)
    bail = torch.zeros(B, dtype=torch.bool, device=dev)
    done = (arow <= 0) & (acol <= 0)
    T = int((n_ins + n_del).max()) + 1 if B else 0
    ops = torch.zeros(B, max(T, 1), dtype=torch.uint8, device=dev)
    cnts = torch.zeros(B, max(T, 1), dtype=torch.long, device=dev)
    t = torch.full((), T - 1, dtype=torch.long, device=dev)
    st = {"arow": arow, "acol": acol, "pend": pend, "bail": bail,
          "done": done}

    def step():
        arow, acol, pend = st["arow"], st["acol"], st["pend"]
        done = st["done"]
        tc = t.clamp(max=R - 1)
        active = ~done & (arow + acol == t)
        fresh = active & (pend == 0)
        lane = inss.gather(1, (tc + 8).expand(B, 1))[:, 0] - arow + p.r
        lane_ok = (lane >= 0) & (lane < LW) & (t < R)
        pk = packed[rows, tc.expand(B), lane.clamp(0, LW - 1)].long()
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
        tt = t.view(1)
        ops.index_copy_(1, tt, op.to(torch.uint8)[:, None])
        cnts.index_copy_(1, tt, torch.where(
            in_m, 1, torch.where(is_i | is_d, run, 0))[:, None])
        arow = torch.where(in_m, arow - 1, torch.where(is_i, arow - run,
                                                       arow))
        acol = torch.where(in_m, acol - 1, torch.where(is_d, acol - run,
                                                       acol))
        pend = torch.where(in_m, pend - 1, pend)
        bail = st["bail"] | bad
        done = done | ((arow <= 0) & (acol <= 0)) | bail
        for k, v in (("arow", arow), ("acol", acol), ("pend", pend),
                     ("bail", bail), ("done", done)):
            st[k].copy_(v)
        t.sub_(1)

    run_rows(step, T, dev)
    bail, done = st["bail"], st["done"]
    bail = bail | ~done
    ops, cnts = ops.cpu().numpy(), cnts.cpu().numpy()
    cigs = []
    for w in range(B):
        m = cnts[w] > 0
        cigs.append(np.repeat(ops[w][m], cnts[w][m]).tobytes().decode("ascii"))
    return cigs, bail.cpu().numpy()


def align(items: Sequence[Tuple[np.ndarray, np.ndarray, str]],
          sub: np.ndarray, cont: np.ndarray, p: AlignParams, device,
          dtype: torch.dtype = torch.float32, block: int = 4096
          ) -> Tuple[List[str], List[bool]]:
    """Extended CIGARs of (int ref, int seq, extended CIGAR) alignments,
    and whether any window of each bailed; windows in blocks of at most
    ``block``, longest first."""
    wins: List[Window] = []
    for i, (ref, seq, cig) in enumerate(items):
        wins += build_windows(ref, seq, cig, p, i)
    wins.sort(key=lambda w: -w.b_rows)
    sub_t = torch.from_numpy(np.ascontiguousarray(sub, np.float32)).to(device)
    cont_t = torch.from_numpy(cont).to(device)
    parts: Dict[Tuple[int, int], str] = {}
    bailed = [False] * len(items)
    for lo in range(0, len(wins), block):
        ws = wins[lo:lo + block]
        batch = pack(ws, p, device)
        planes = window_dp(batch, sub_t, cont_t, p, dtype)
        cigs, bail = traceback(planes, batch, p)
        del planes, batch
        for w, c, b in zip(ws, cigs, bail):
            parts[w.key] = c
            bailed[w.key[0]] |= bool(b)
    out = []
    for i in range(len(items)):
        ci, s = 0, []
        while (i, ci) in parts:
            s.append(parts[(i, ci)])
            ci += 1
        out.append("".join(s))
    return out, bailed
