"""Batched banded 5-state n-polymer DP in plain PyTorch.

A port of ``npore_tpu/ops/band_dp.py::make_window_dp`` (the reference
align() kernel, src/aln.pyx:379-667, in lockstep form): one anti-diagonal
row per step, vectorised over windows, with the band on a 64-wide lane
axis. It is the CPU engine's DP and the oracle of the CUDA kernel
(``ops/dp_cuda.py``), which computes the same planes bit for bit:

* values are float32 adds with strict ``<`` selects, in the state order
  MAT, INS, LEN, DEL, SHR;
* LEN/SHR runs are gathered at the target cell from the row n back, and
  carry their anchor value, lane and coordinate (see the JAX module's
  docstring for the derivation);
* reads outside a window's padded buffers return 0 (zero-fill), and the
  continuation lookup clips its flat index, k clamped at 127 (exact: the
  np scores saturate there);
* start penalties are read from ``cont`` at k=1 and the guarded l, which
  equals the ``len_start``/``shr_start`` planes wherever a candidate is
  valid (those need l > 0, i.e. a position inside the ref).

Input: a batch dict of tensors (``engine/windows.pack_batch`` or
``pack_group`` views; any integer dtypes). Output: the MAT planes
``typ (B, R, 64) int8`` and ``run (B, R, 64) int32``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..config import AlignConfig

MAT, INS, LEN, DEL, SHR = 0, 1, 2, 3, 4
LW = 64          # lane width: band padded to 64 (needs 2r+1 <= 64)
PADL = 80        # left zero-padding of per-window buffers
KDIM = 128
NL = 101


def check_band(cfg: AlignConfig) -> None:
    """The band must fit the lanes, and n-polymer lengths the tables (and
    the int8 L/L_IDX planes of ``pack_group``)."""
    if not 0 < 2 * cfg.r + 1 <= LW:
        raise ValueError(f"band 2r+1 = {2 * cfg.r + 1} must fit in {LW} lanes")
    if not 0 < cfg.max_l < NL:
        raise ValueError(f"max_l = {cfg.max_l} must be in [1, {NL - 1}]")


def pack_planes(typ: torch.Tensor, run: torch.Tensor) -> torch.Tensor:
    """MAT planes as the kernels store them: ``typ | run << 3`` int32."""
    return typ.to(torch.int32) | (run.to(torch.int32) << 3)


def unpack_planes(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (packed & 7).to(torch.int8), packed >> 3


def _shift(x: torch.Tensor, off: torch.Tensor, lanes: torch.Tensor
           ) -> torch.Tensor:
    """out[b, c, j] = x[b, c, j + off[b]] with zero fill (|off| <= 8)."""
    ext = F.pad(x, (8, 8))
    idx = (8 + off + lanes).clamp_(0, LW + 15)
    return ext.gather(2, idx[:, None, :].expand(-1, x.shape[1], -1))


def window_dp(batch: Dict[str, torch.Tensor], tables: Dict[str, torch.Tensor],
              cfg: AlignConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MAT planes (typ, run) of every window of ``batch``."""
    check_band(cfg)
    r, max_n = cfg.r, cfg.max_n
    inss = batch["inss"].long()
    dev = inss.device
    B, R = inss.shape[0], inss.shape[1] - 8
    f32 = torch.float32
    INF = torch.tensor(cfg.inf, dtype=f32, device=dev)
    istart = torch.tensor(cfg.indel_start, dtype=f32, device=dev)
    iext = torch.tensor(cfg.indel_extend, dtype=f32, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    sub_flat = tables["sub"].reshape(-1).to(f32)
    cont = tables["cont"].reshape(-1).to(f32)
    ncont = cont.numel()
    lanes = torch.arange(LW, device=dev)

    def col(name):
        return batch[name].long()[:, None]

    n_ins, n_del = col("n_ins"), col("n_del")
    b_rows = col("b_rows")
    ref_guard, seq_guard = col("ref_guard"), col("seq_guard")
    # 64 extra zeros on the right: every read lands inside the buffer, and
    # the clamp below only ever lands on padding (zero-fill semantics)
    seq = F.pad(batch["seqbuf"].long(), (0, LW))
    ref = F.pad(batch["refbuf"].long(), (0, LW))
    A = seq.shape[1]

    def planes(name):
        return F.pad(batch[name].long(), (0, 0, 0, LW)).reshape(B, -1)

    l_seq, lidx_seq = planes("l_seq"), planes("lidx_seq")
    l_ref, lidx_ref = planes("l_ref"), planes("lidx_ref")
    ns = torch.arange(1, max_n + 1, device=dev)[None, :, None]   # n
    nis = ns - 1

    def at(buf, pos):           # buf[b, PADL + pos] with zero fill
        return buf.gather(1, (PADL + pos).clamp(0, A - 1).reshape(B, -1)
                          ).reshape(pos.shape)

    def at_plane(buf, pos, ni):  # buf[b, PADL + pos, ni] with zero fill
        flat = (PADL + pos).clamp(0, A - 1) * max_n + ni
        return buf.gather(1, flat.reshape(B, -1)).reshape(flat.shape)

    def cont_at(side, ni, l, k):
        flat = ((side * max_n + ni) * NL + l) * KDIM + k
        return cont[flat.clamp(0, ncont - 1)]

    H = max(max_n, 2)
    # row state: F = [matv, lenav, shrav, insv, delv] (f32),
    # I = [matt, matr, lenr, lenac, lenaa, shrr, shrac, shraa, insr, delr]
    zero_row = (torch.zeros(B, 5, LW, dtype=f32, device=dev),
                torch.zeros(B, 10, LW, dtype=torch.long, device=dev))
    hist = [zero_row] * H         # hist[k] holds row t-1-k
    typ_out = torch.zeros(B, R, LW, dtype=torch.int8, device=dev)
    run_out = torch.zeros(B, R, LW, dtype=torch.int32, device=dev)
    wall = (lanes == 0) | (lanes == 2 * r)
    dseq = torch.arange(-6, 0, device=dev)[None, :, None]       # arow + d
    dref = torch.arange(-1, 6, device=dev)[None, :, None]       # acol + d

    for t in range(R):
        ii = inss[:, 8 + t, None]
        arow = ii + r - lanes
        acol = (t - ii) - r + lanes
        in_range = ((arow >= 0) & (acol >= 0) & (arow <= n_ins)
                    & (acol <= n_del) & (t <= b_rows - 1))
        live = in_range & ~wall & (lanes < 2 * r + 1)
        first_row = arow == 0
        first_col = acol == 0

        sw = at(seq, arow[:, None, :] + dseq)      # seq[arow - 6 .. arow - 1]
        rw = at(ref, acol[:, None, :] + dref)      # ref[acol - 1 .. acol + 5]
        ref_zero = acol >= ref_guard
        l_n_all = torch.where(ref_zero[:, None], 0,
                              at_plane(l_ref, acol[:, None, :], nis))
        lidx_n_all = torch.where(ref_zero[:, None], 0,
                                 at_plane(lidx_ref, acol[:, None, :], nis))
        src_col = acol[:, None, :] - ns
        rzs_all = src_col >= ref_guard[:, None]
        l_n2_all = torch.where(rzs_all, 0, at_plane(l_ref, src_col, nis))
        lidx_n2_all = torch.where(rzs_all, 0, at_plane(lidx_ref, src_col, nis))
        src_row = arow[:, None, :] - ns
        sg_all = src_row >= seq_guard[:, None]
        lseq_all = torch.where(sg_all, 0, at_plane(l_seq, src_row, nis))
        lidxseq_all = torch.where(sg_all, 0, at_plane(lidx_seq, src_row, nis))

        step1 = ii - inss[:, 7 + t, None]
        Fp, Ip = hist[0]

        # --- INS (src/aln.pyx:524-543) ---
        Ft, It = _shift(Fp, 1 - step1, lanes), _shift(Ip, 1 - step1, lanes)
        v1 = Ft[:, 0] + istart
        v2 = Ft[:, 3] + iext
        use2 = v2 < v1
        run2 = torch.where(arow == 1, 1, It[:, 8] + 1)
        ins_v = torch.where(use2, v2, v1)
        ins_r = torch.where(use2, run2, 1)
        ins_v = torch.where(first_row, (acol + 1).to(f32) * INF, ins_v)
        ins_r = torch.where(first_row, acol, ins_r)

        # --- DEL (src/aln.pyx:546-565) ---
        Fl, Il = _shift(Fp, -step1, lanes), _shift(Ip, -step1, lanes)
        v1 = Fl[:, 0] + istart
        v2 = Fl[:, 4] + iext
        use2 = v2 < v1
        run2 = torch.where(acol == 1, 1, Il[:, 9] + 1)
        del_v = torch.where(use2, v2, v1)
        del_r = torch.where(use2, run2, 1)
        del_v = torch.where(first_col, (arow + 1).to(f32) * INF, del_v)
        del_r = torch.where(first_col, arow, del_r)

        # --- LEN / SHR (gather form of src/aln.pyx:601-667) ---
        zf = torch.zeros(B, LW, dtype=f32, device=dev)
        zi = torch.zeros(B, LW, dtype=torch.long, device=dev)
        len_v = (arow + acol).to(f32) * INF
        len_r, len_av, len_ac, len_aa = zi, zf, zi, zi
        shr_v = len_v
        shr_r, shr_av, shr_ac, shr_aa = zi, zf, zi, zi
        for n in range(max_n, 0, -1):
            ni = n - 1
            Fn, In = hist[n - 1]
            dI = ii - inss[:, 8 + t - n, None]

            # LEN source: (arow - n, acol), row t-n, lane + (n - dI)
            s_n = n - dI
            Fs, Is = _shift(Fn, s_n, lanes), _shift(In, s_n, lanes)
            matv_src, lenav_src = Fs[:, 0], Fs[:, 1]
            lenr_src, lenac_src, lenaa_src = Is[:, 2], Is[:, 3], Is[:, 4]
            src_lane = lanes + s_n
            src_ok = ((arow - n >= 0) & (src_lane >= 1)
                      & (src_lane <= 2 * r - 1) & (t >= n))
            l_n = l_n_all[:, ni]
            # match(seq[siS+1 : +n], ref[riT+1 : +n]) with the reference's
            # slice truncation (src/aln.pyx:362-372, 604-607)
            lenA = (n_ins + 1 - (arow - n)).clamp(0, n)
            lenB = (n_del + 1 - acol).clamp(0, n)
            mok = lenA == lenB
            for k in range(n):
                mok = mok & ((k >= lenA) | (sw[:, 6 + k - n] == rw[:, k + 1]))
            valid = (src_ok & (l_n > 0) & (lseq_all[:, ni] > 0)
                     & (lidx_n_all[:, ni] == 0) & mok & (lanes > 0))
            start_case = lidxseq_all[:, ni] == 0
            cand_s = matv_src + cont_at(0, ni, l_n, 1)
            k_c = torch.div(lenr_src, n, rounding_mode="floor") + 1
            cand_c = lenav_src + cont_at(0, ni, l_n, k_c.clamp(max=KDIM - 1))
            cont_ok = (lenr_src > 0) & (lenaa_src >= 0) & (lenac_src < 2 * r)
            cand = torch.where(start_case, cand_s,
                               torch.where(cont_ok, cand_c, inf))
            upd = valid & (cand < len_v)
            len_v = torch.where(upd, cand, len_v)
            len_r = torch.where(upd, torch.where(start_case, n,
                                                 lenr_src + n), len_r)
            len_av = torch.where(upd, torch.where(start_case, matv_src,
                                                  lenav_src), len_av)
            len_ac = torch.where(upd, torch.where(start_case, src_lane,
                                                  lenac_src), len_ac)
            len_aa = torch.where(upd, torch.where(start_case, arow - n,
                                                  lenaa_src), len_aa)

            # SHR source: (arow, acol - n), row t-n, lane - dI
            Fs, Is = _shift(Fn, -dI, lanes), _shift(In, -dI, lanes)
            matv_src2, shrav_src = Fs[:, 0], Fs[:, 2]
            shrr_src, shrac_src, shraa_src = Is[:, 5], Is[:, 6], Is[:, 7]
            src_lane2 = lanes - dI
            src_ok2 = ((acol - n >= 0) & (src_lane2 >= 1)
                       & (src_lane2 <= 2 * r - 1) & (t >= n))
            l_n2 = l_n2_all[:, ni]
            valid2 = src_ok2 & (l_n2 > 0) & (lanes < 2 * r)
            start2 = lidx_n2_all[:, ni] == 0
            cand_s2 = matv_src2 + cont_at(1, ni, l_n2, 1)
            k_c2 = torch.div(shrr_src, n, rounding_mode="floor") + 1
            cand_c2 = shrav_src + cont_at(1, ni, l_n2,
                                          k_c2.clamp(max=KDIM - 1))
            cont_ok2 = (shrr_src > 0) & (shraa_src >= 0) & (shrac_src > 0)
            cand2 = torch.where(start2, cand_s2,
                                torch.where(cont_ok2, cand_c2, inf))
            upd2 = valid2 & (cand2 < shr_v)
            shr_v = torch.where(upd2, cand2, shr_v)
            shr_r = torch.where(upd2, torch.where(start2, n, shrr_src + n),
                                shr_r)
            shr_av = torch.where(upd2, torch.where(start2, matv_src2,
                                                   shrav_src), shr_av)
            shr_ac = torch.where(upd2, torch.where(start2, src_lane2,
                                                   shrac_src), shr_ac)
            shr_aa = torch.where(upd2, torch.where(start2, acol - n,
                                                   shraa_src), shr_aa)

        # --- MAT (src/aln.pyx:568-592) ---
        Fd, Id = hist[1]
        dI2 = ii - inss[:, 6 + t, None]
        Fd, Id = _shift(Fd, 1 - dI2, lanes), _shift(Id, 1 - dI2, lanes)
        matv_diag, matt_diag, matr_diag = Fd[:, 0], Id[:, 0], Id[:, 1]
        sub = sub_flat[(sw[:, 5] * 5 + rw[:, 0]).clamp(0, 24)]
        can_diag = (arow > 0) & (acol > 0)
        run_diag = torch.where(matt_diag == MAT, matr_diag + 1, 1)
        md = matv_diag + sub
        v1 = torch.where(can_diag, md, del_v + INF)
        mat_v = torch.where(can_diag, md, 0.0)
        mat_t = zi
        mat_r = torch.where(can_diag, run_diag, 0)
        for ti, tv, tr in ((INS, ins_v, ins_r), (LEN, len_v, len_r),
                           (DEL, del_v, del_r), (SHR, shr_v, shr_r)):
            upd = tv < v1
            v1 = torch.where(upd, tv, v1)
            mat_v = torch.where(upd, tv, mat_v)
            mat_t = torch.where(upd, ti, mat_t)
            mat_r = torch.where(upd, tr, mat_r)

        # --- post overwrites: first-row LEN / first-col SHR
        # (src/aln.pyx:596-599, 637-640; after the MAT reduce) ---
        len_r = torch.where(first_row, acol, len_r)
        shr_r = torch.where(first_col, arow, shr_r)

        # --- walls and out-of-range cells (src/aln.pyx:497-507) ---
        wall_in = wall & in_range
        wall_v = torch.tensor(float(t + 1), dtype=f32, device=dev) * INF

        def fin_v(v):
            return torch.where(in_range, torch.where(wall_in, wall_v, v), 0.0)

        def fin_r(rr):
            return torch.where(in_range & ~wall_in, rr, 0)

        mat_t = torch.where(in_range & ~wall_in, mat_t, MAT)
        dead = ~live
        Frow = torch.stack([fin_v(mat_v), torch.where(dead, 0.0, len_av),
                            torch.where(dead, 0.0, shr_av), fin_v(ins_v),
                            fin_v(del_v)], dim=1)
        Irow = torch.stack([mat_t, fin_r(mat_r), fin_r(len_r),
                            torch.where(dead, 0, len_ac),
                            torch.where(dead, 0, len_aa), fin_r(shr_r),
                            torch.where(dead, 0, shr_ac),
                            torch.where(dead, 0, shr_aa), fin_r(ins_r),
                            fin_r(del_r)], dim=1)
        hist = [(Frow, Irow)] + hist[:-1]
        typ_out[:, t] = mat_t.to(torch.int8)
        run_out[:, t] = Irow[:, 1].to(torch.int32)
    return typ_out, run_out
