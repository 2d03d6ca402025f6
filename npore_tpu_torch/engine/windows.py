"""Window construction and group packing for the batched DP.

A window is one max_b_rows chunk of one alignment, carrying everything the
DP needs: padded int sequences, chunk-local n-polymer tables and the local
prefix-I path counts. Chunk boundaries and slices replicate the reference
exactly (reference: src/aln.pyx:344-358, 445-456).

``pack_batch`` is the JAX package's layout (int32 planes plus the start
tables), kept as the reference of ``pack_group``; ``pack_group`` packs one
flat byte buffer per group with int8 n-polymer planes from the host scan,
and no start tables (the DP reads them from ``cont``). The engine fills
only that buffer's prefix on the host (``fill_group``) and scans on the
device (``ops/npinfo_cuda.fill_planes``); ``pack_group`` is the reference
it is held to byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig
from ..golden.align import get_breaks
from ..native import np_info, path_inss_native
from ..ops.npinfo_host import get_np_info_vec
from ..ops.tables import build_start_tables

PADL = 80        # left zero-padding of per-window arrays
PADR = 40        # right zero-padding

_IS_M = np.zeros(256, dtype=bool)
for _c in "MX=":
    _IS_M[ord(_c)] = True


def path_inss(cigar: str) -> np.ndarray:
    """Prefix-I counts along the reparameterized path (reference:
    src/aln.pyx:279-292 after the :386 M->DI rewrite). Each 'M'/'X'/'='
    contributes a D step then an I step; 'I'/'D' one step. Prefers the
    one-pass C++ kernel; the numpy form is its fallback."""
    fast = path_inss_native(cigar)
    if fast is not None:
        return fast
    raw = np.frombuffer(cigar.encode("ascii"), dtype=np.uint8)
    m = _IS_M[raw]
    sizes = m.astype(np.int64) + 1
    ends = np.cumsum(sizes)
    n2 = int(ends[-1]) if len(ends) else 0
    starts = ends - sizes
    is_i = np.zeros(n2, dtype=bool)
    is_i[starts[m] + 1] = True                 # the I of each D,I pair
    is_i[starts[raw == ord("I")]] = True
    inss = np.zeros(n2 + 1, dtype=np.int64)
    np.cumsum(is_i, out=inss[1:])
    return inss


@dataclass
class Window:
    key: Tuple[int, int]        # (alignment index, chunk index)
    b_rows: int
    n_ins: int                  # seq span of the chunk
    n_del: int                  # ref span of the chunk
    seq: np.ndarray             # int8 chunk seq slice (with +1 lookahead)
    ref: np.ndarray             # int8 chunk ref slice (with +1 lookahead)
    inss_local: np.ndarray      # int32 (b_rows,) prefix-I counts
    ref_guard: int              # local a_col at which ref n-polymer info zeroes
    seq_guard: int              # local a_row at which seq n-polymer info zeroes


def build_windows(full_ref: np.ndarray, full_seq: np.ndarray, cigar: str,
                  cfg: AlignConfig, aln_idx: int = 0) -> List[Window]:
    """Split one alignment into independent chunk windows
    (reference: src/aln.pyx:386-455)."""
    inss = path_inss(cigar)
    # every path step is I or D after the M->DI rewrite, so the prefix-D
    # counts are just step-index minus prefix-I counts
    dels = np.arange(len(inss), dtype=np.int64) - inss
    breaks = get_breaks(cfg.max_b_rows, len(full_seq) + len(full_ref) + 1,
                        inss, dels)
    out = []
    for ci in range(len(breaks) - 1):
        brk, nxt = breaks[ci], breaks[ci + 1]
        ib, db = int(inss[brk]), int(dels[brk])
        inx, dnx = int(inss[nxt]), int(dels[nxt])
        out.append(Window(
            key=(aln_idx, ci),
            b_rows=nxt - brk + 1,
            n_ins=inx - ib, n_del=dnx - db,
            seq=np.asarray(full_seq[ib:inx + 1], dtype=np.int8),
            ref=np.asarray(full_ref[db:dnx + 1], dtype=np.int8),
            inss_local=(inss[brk:nxt + 1] - ib).astype(np.int32),
            ref_guard=len(full_ref) - db,
            seq_guard=len(full_seq) - ib,
        ))
    return out


def pack_batch(windows: Sequence[Window], R_max: int, cont: np.ndarray,
               max_n: int = 6) -> Dict[str, np.ndarray]:
    """Pad and stack windows in the JAX package's batch layout
    (npore_tpu/engine/windows.py::pack_batch)."""
    B = len(windows)
    A = PADL + R_max + PADR
    batch = {
        "seqbuf": np.zeros((B, A), np.int32),
        "refbuf": np.zeros((B, A), np.int32),
        "l_seq": np.zeros((B, A, max_n), np.int32),
        "lidx_seq": np.zeros((B, A, max_n), np.int32),
        "l_ref": np.zeros((B, A, max_n), np.int32),
        "lidx_ref": np.zeros((B, A, max_n), np.int32),
        "len_start": np.zeros((B, A, max_n), np.float32),
        "shr_start": np.zeros((B, A, max_n), np.float32),
        "inss": np.zeros((B, R_max + 8), np.int32),
        "b_rows": np.zeros((B,), np.int32),
        "n_ins": np.zeros((B,), np.int32),
        "n_del": np.zeros((B,), np.int32),
        "ref_guard": np.zeros((B,), np.int32),
        "seq_guard": np.zeros((B,), np.int32),
    }
    for i, w in enumerate(windows):
        ns, nr = len(w.seq), len(w.ref)
        batch["seqbuf"][i, PADL:PADL + ns] = w.seq
        batch["refbuf"][i, PADL:PADL + nr] = w.ref
        npi_s = get_np_info_vec(w.seq.astype(np.uint8), max_n)
        npi_r = get_np_info_vec(w.ref.astype(np.uint8), max_n)
        batch["l_seq"][i, PADL:PADL + ns] = npi_s[:, 0, :]
        batch["lidx_seq"][i, PADL:PADL + ns] = npi_s[:, 1, :]
        batch["l_ref"][i, PADL:PADL + nr] = npi_r[:, 0, :]
        batch["lidx_ref"][i, PADL:PADL + nr] = npi_r[:, 1, :]
        ls, ss = build_start_tables(npi_r[:, 0, :], cont, max_n)
        batch["len_start"][i, PADL:PADL + nr] = ls
        batch["shr_start"][i, PADL:PADL + nr] = ss
        batch["inss"][i, 8:8 + w.b_rows] = w.inss_local
        # keep prefix counts constant past the end so padded rows are benign
        batch["inss"][i, 8 + w.b_rows:] = w.inss_local[-1]
        batch["b_rows"][i] = w.b_rows
        batch["n_ins"][i] = w.n_ins
        batch["n_del"][i] = w.n_del
        batch["ref_guard"][i] = w.ref_guard
        batch["seq_guard"][i] = w.seq_guard
    return batch


SCALARS = ("b_rows", "n_ins", "n_del", "ref_guard", "seq_guard")
PLANES = ("l_seq", "lidx_seq", "l_ref", "lidx_ref")


def group_layout(B: int, R_max: int, max_n: int
                 ) -> List[Tuple[str, int, Tuple[int, ...], np.dtype]]:
    """(name, byte offset, shape, dtype) of every array in a group buffer;
    offsets are 16-byte aligned so each slice views as its dtype."""
    A = PADL + R_max + PADR
    specs = [("inss", (B, R_max + 8), np.int32)]
    specs += [(k, (B,), np.int32) for k in SCALARS]
    specs += [("seqbuf", (B, A), np.int8), ("refbuf", (B, A), np.int8)]
    specs += [(k, (B, A, max_n), np.int8) for k in PLANES]
    out, off = [], 0
    for name, shape, dt in specs:
        out.append((name, off, shape, np.dtype(dt)))
        off += -(-int(np.prod(shape)) * np.dtype(dt).itemsize // 16) * 16
    return out


def group_nbytes(layout) -> int:
    name, off, shape, dt = layout[-1]
    return off + int(np.prod(shape)) * dt.itemsize


def prefix_nbytes(layout) -> int:
    """Bytes of a group buffer before its n-polymer planes, which
    ``group_layout`` places last: the part the host fills."""
    return layout[-len(PLANES)][1]


def _views(buf, layout, view):
    return {name: view(buf, off, shape, dt) for name, off, shape, dt in layout}


def numpy_views(buf: np.ndarray, layout) -> Dict[str, np.ndarray]:
    return _views(buf, layout, lambda b, o, sh, dt: b[
        o:o + int(np.prod(sh)) * dt.itemsize].view(dt).reshape(sh))


_TORCH_DT = {np.dtype(np.int8): torch.int8, np.dtype(np.int32): torch.int32}


def tensor_views(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Typed views of a flat uint8 group buffer (host or device)."""
    return _views(buf, layout, lambda b, o, sh, dt: b[
        o:o + int(np.prod(sh)) * dt.itemsize].view(_TORCH_DT[dt]).view(sh))


def fill_group(windows: Sequence[Window], R_max: int, max_n: int,
               out: np.ndarray = None) -> np.ndarray:
    """The host's part of a group buffer: every byte of ``pack_group``'s
    buffer before the n-polymer planes (``inss``, the scalars, ``seqbuf``
    and ``refbuf``, and the alignment gaps), which ``group_layout`` places
    last; the device writes the planes from ``seqbuf``/``refbuf``
    (``ops/npinfo_cuda.fill_planes``). Writes into ``out`` if given (e.g.
    the numpy view of a pinned tensor). Returns the prefix, of
    ``prefix_nbytes`` bytes."""
    layout = group_layout(len(windows), R_max, max_n)
    head, off = layout[:-len(PLANES)], prefix_nbytes(layout)
    buf = np.empty(off, np.uint8) if out is None else out[:off]
    end = 0
    for name, o, shape, dt in head:         # the alignment gaps
        buf[end:o] = 0
        end = o + int(np.prod(shape)) * dt.itemsize
    buf[end:off] = 0
    v = numpy_views(buf, head)
    v["inss"][:, :8] = 0
    v["seqbuf"][:] = 0
    v["refbuf"][:] = 0
    for i, w in enumerate(windows):
        v["seqbuf"][i, PADL:PADL + len(w.seq)] = w.seq
        v["refbuf"][i, PADL:PADL + len(w.ref)] = w.ref
        v["inss"][i, 8:8 + w.b_rows] = w.inss_local
        v["inss"][i, 8 + w.b_rows:] = w.inss_local[-1]
    for k in SCALARS:
        v[k][:] = [getattr(w, k) for w in windows]
    return buf


def pack_group(windows: Sequence[Window], R_max: int, max_n: int,
               out: np.ndarray = None) -> Tuple[np.ndarray, list]:
    """Pack windows into one flat byte buffer (``out`` if given, e.g. the
    numpy view of a pinned tensor). Same values as ``pack_batch``: L and
    L_IDX never exceed max_l <= 100 (``check_band``), so int8 holds them.
    n-polymer info comes from the C++ scanner (bit-identical to
    ``get_np_info_vec``) at max_l 100. The engines fill groups with
    ``fill_group`` and scan on the device; this is the host reference
    they are held to."""
    layout = group_layout(len(windows), R_max, max_n)
    nbytes = group_nbytes(layout)
    buf = np.zeros(nbytes, np.uint8) if out is None else out[:nbytes]
    if out is not None:
        buf[:] = 0
    v = numpy_views(buf, layout)
    for i, w in enumerate(windows):
        ns, nr = len(w.seq), len(w.ref)
        v["seqbuf"][i, PADL:PADL + ns] = w.seq
        v["refbuf"][i, PADL:PADL + nr] = w.ref
        npi_s = np_info(w.seq, max_n)
        npi_r = np_info(w.ref, max_n)
        v["l_seq"][i, PADL:PADL + ns] = npi_s[:, 0, :]
        v["lidx_seq"][i, PADL:PADL + ns] = npi_s[:, 1, :]
        v["l_ref"][i, PADL:PADL + nr] = npi_r[:, 0, :]
        v["lidx_ref"][i, PADL:PADL + nr] = npi_r[:, 1, :]
        v["inss"][i, 8:8 + w.b_rows] = w.inss_local
        v["inss"][i, 8 + w.b_rows:] = w.inss_local[-1]
    for k in SCALARS:
        v[k][:] = [getattr(w, k) for w in windows]
    return buf, layout
