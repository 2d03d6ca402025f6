"""CIGAR string utilities (reference: src/cig.pyx).

Expanded CIGARs are either Python strings of op chars ('DMMMII') or uint8
numpy arrays using the 'MIDNSHP=XB' encoding (constants.CIGARS); run-length
CIGARs are standard SAM strings ('1D3M2I').
"""
from __future__ import annotations

import itertools
import re
from typing import Iterable, List, Tuple

import numpy as np

from ..constants import (CIGARS, CONSUMES_QUERY, CONSUMES_REF, OP_D, OP_E,
                         OP_I, OP_M, OP_X)

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=XB])")


def expand_cigar(cigar: str) -> str:
    """'1D3M2I' -> 'DMMMII' (reference: src/cig.pyx:42-57)."""
    if not cigar or cigar == "*":
        return ""
    return "".join(int(n) * op for n, op in _CIGAR_RE.findall(cigar))


def collapse_cigar(extended: Iterable[str], return_groups: bool = False):
    """'DMMMII' -> '1D3M2I' (reference: src/cig.pyx:13-38)."""
    if isinstance(extended, str) and extended:
        # run-length encode via numpy boundaries (hot path)
        b = np.frombuffer(extended.encode("ascii"), dtype=np.uint8)
        cuts = np.concatenate(([0], np.flatnonzero(b[1:] != b[:-1]) + 1,
                               [len(b)]))
        groups = [(int(cuts[i + 1] - cuts[i]), extended[cuts[i]])
                  for i in range(len(cuts) - 1)]
    else:
        groups = [(len(list(g)), op) for op, g in itertools.groupby(extended)]
    if return_groups:
        return groups
    return "".join(f"{n}{op}" for n, op in groups)


def cigar_tuples(cigar: str) -> List[Tuple[int, str]]:
    """Run-length CIGAR -> [(count, op), ...]."""
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


def seq_len(cigar: str) -> int:
    """Query bases consumed by an extended CIGAR (reference: src/cig.pyx:196-201)."""
    return sum(op in CONSUMES_QUERY for op in cigar)


def ref_len(cigar: str) -> int:
    """Reference bases consumed by an extended CIGAR (reference: src/cig.pyx:203-208)."""
    return sum(op in CONSUMES_REF for op in cigar)


def ref_len_rl(cigar: str) -> int:
    """Reference bases consumed by a run-length CIGAR."""
    return sum(n for n, op in cigar_tuples(cigar) if op in CONSUMES_REF)


def push_indels_left(cigar: np.ndarray, seq: np.ndarray, push_op: int) -> np.ndarray:
    """Push runs of `push_op` (OP_I or OP_D) leftwards through matches while
    the moved-over sequence is unchanged (reference: src/cig.pyx:102-159).

    `cigar` is a uint8 extended-cigar array, modified in place and returned.
    `seq` is the int-encoded sequence the indel consumes: the reference for
    deletions, the query for insertions (see src/bam.pyx:73-75).
    """
    cig_ptr = 0
    seq_ptr = 0
    cig_len = len(cigar)
    while cig_ptr < cig_len:
        op = cigar[cig_ptr]
        if op == push_op:
            indel_len = 1
            while (cig_ptr + indel_len < cig_len
                   and cigar[cig_ptr + indel_len] == push_op):
                indel_len += 1
        else:
            cig_ptr += 1
            if op == OP_M or op == OP_X or op == OP_E:
                seq_ptr += 1
            continue

        # shift left while preceding op is a match and sequence is periodic
        nshifts = 0
        while (cig_ptr - nshifts > 0 and seq_ptr - nshifts > 0
               and seq[seq_ptr - nshifts - 1] == seq[seq_ptr - nshifts - 1 + indel_len]
               and (cigar[cig_ptr - nshifts - 1] == OP_E
                    or cigar[cig_ptr - nshifts - 1] == OP_M)):
            nshifts += 1

        if nshifts:
            moved = cigar[cig_ptr - nshifts:cig_ptr].copy()
            cigar[cig_ptr - nshifts:cig_ptr - nshifts + indel_len] = \
                cigar[cig_ptr:cig_ptr + indel_len]
            cigar[cig_ptr - nshifts + indel_len:cig_ptr + indel_len] = moved

        cig_ptr += indel_len
        # reference quirk kept intact: after handling an indel run, seq_ptr
        # advances as if by the *pre-loop* op (src/cig.pyx:153-157)
        if op == OP_M or op == OP_X or op == OP_E:
            seq_ptr += 1
        elif op == push_op:
            seq_ptr += indel_len
    return cigar


def push_inss_thru_dels(cigar: np.ndarray) -> np.ndarray:
    """Rewrite each 'D+I+' juxtaposition as 'I+D+' so insertions can keep
    moving left on later passes (reference: src/cig.pyx:164-192). In place."""
    cig_len = len(cigar)
    for i in range(cig_len - 1):
        if cigar[i] == OP_D and cigar[i + 1] == OP_I:
            del_idx = i - 1
            while del_idx >= 0 and cigar[del_idx] == OP_D:
                del_idx -= 1
            dels = i - del_idx
            ins_idx = i + 1
            while ins_idx < cig_len and cigar[ins_idx] == OP_I:
                ins_idx += 1
            inss = ins_idx - i - 1
            cigar[del_idx + 1:del_idx + 1 + inss] = OP_I
            cigar[del_idx + 1 + inss:del_idx + 1 + inss + dels] = OP_D
    return cigar


def normalize_cigar(cigar: str, int_ref: np.ndarray, int_seq: np.ndarray) -> str:
    """Left-normalize an extended CIGAR to a fixpoint, then fuse 'ID' -> 'M'
    (reference: src/bam.pyx:64-78).

    Input: extended cigar over {M,I,D} (X/= already mapped to M by caller or
    here), plus the int-encoded reference and query windows it aligns.
    """
    from ..constants import cig_to_int, int_to_cig
    cigar = cigar.replace("X", "M").replace("=", "M")
    int_cig = cig_to_int(cigar)
    from ..native import normalize_cigar_ints
    fast = normalize_cigar_ints(int_cig, int_ref, int_seq)
    if fast is not None:
        int_cig = fast
    else:
        while True:
            old = int_cig.copy()
            int_cig = push_indels_left(int_cig, int_ref, OP_D)
            int_cig = push_inss_thru_dels(int_cig)
            int_cig = push_indels_left(int_cig, int_seq, OP_I)
            int_cig = push_inss_thru_dels(int_cig)
            if np.array_equal(old, int_cig):
                break
    return int_to_cig(int_cig).replace("ID", "M")


# extended-cigar chars -> {M,I,D} int ops with X/= folded into M
_EXT2MID_LUT = np.full(256, 255, dtype=np.uint8)
for _ch, _op in (("M", OP_M), ("I", OP_I), ("D", OP_D),
                 ("X", OP_M), ("=", OP_M)):
    _EXT2MID_LUT[ord(_ch)] = _op
_MID_TRANS = bytes("MID", "ascii") + bytes(253)


def finalize_cigar(extended: str, int_ref: np.ndarray,
                   int_seq: np.ndarray) -> str:
    """normalize_cigar + collapse_cigar fused into one codec pass
    (reference: src/bam.pyx:64-83 normalize-then-write).

    Equivalent to ``collapse_cigar(normalize_cigar(extended, ...))`` but
    skips the intermediate string round-trips: chars -> int ops (X/= -> M),
    native left-normalize fixpoint, vectorized 'ID' -> 'M' pair fusion,
    run-length encode. This is the realigner's per-read hot path; with a
    compiler the whole pass runs in one C++ call.
    """
    from ..native import finalize_cigar_native
    done = finalize_cigar_native(extended, int_ref, int_seq)
    if done is not None:
        return done
    raw = np.frombuffer(extended.encode("ascii"), dtype=np.uint8)
    int_cig = _EXT2MID_LUT[raw]
    if (int_cig == 255).any():
        bad = extended[int(np.argmax(int_cig == 255))]
        raise ValueError(f"invalid CIGAR op {bad!r}")
    from ..native import normalize_cigar_ints
    fast = normalize_cigar_ints(int_cig, int_ref, int_seq)
    if fast is not None:
        int_cig = fast
    else:
        while True:
            old = int_cig.copy()
            int_cig = push_indels_left(int_cig, int_ref, OP_D)
            int_cig = push_inss_thru_dels(int_cig)
            int_cig = push_indels_left(int_cig, int_seq, OP_I)
            int_cig = push_inss_thru_dels(int_cig)
            if np.array_equal(old, int_cig):
                break
    n = len(int_cig)
    if n == 0:
        return ""
    if n > 1:
        # 'ID' pairs fuse to 'M'; pairs can never overlap (a pair's D can't
        # start another pair), so one vectorized pass matches str.replace
        pair = np.flatnonzero((int_cig[:-1] == OP_I) & (int_cig[1:] == OP_D))
        if len(pair):
            int_cig[pair] = OP_M
            keep = np.ones(n, dtype=bool)
            keep[pair + 1] = False
            int_cig = int_cig[keep]
    cuts = np.flatnonzero(int_cig[1:] != int_cig[:-1]) + 1
    starts = np.concatenate(([0], cuts))
    lens = np.diff(np.concatenate((starts, [len(int_cig)]))).tolist()
    ops = int_cig[starts].tobytes().translate(_MID_TRANS).decode("ascii")
    return "".join(f"{c}{o}" for c, o in zip(lens, ops))
