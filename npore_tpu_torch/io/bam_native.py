"""ctypes wrapper for the C++ streaming BAM reader (native/bamio.cpp).

Drop-in replacement for io/bam.BamReader on the hot host path: BGZF blocks
are inflated in C++ with bounded memory (the pure-Python reader inflates the
whole file up front), records decode in batches into flat buffers, and —
when ``prep`` is on — each record arrives with its realignment inputs
already computed natively: int-coded aligned reference (MD reconstruction),
int-coded aligned query, and the expanded clip-stripped CIGAR. That moves
the whole per-base Python host path (io/sam.get_reference_sequence, CIGAR
expansion, base int-coding) into C++, the way the reference leans on
htslib + Cython (reference: src/bam.pyx:18-47).

Region fetches use the sparse (ref_id, pos) -> virtual-offset index the
scan builds, so coordinate-sorted BAMs seek instead of rescanning.
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .sam import SamRecord, parse_tag
from ..native import get_lib

_NF = 26
_EXCL_DEFAULT = 0          # callers filter; fetch() excludes nothing itself

_bamio_ready = False


def _bind(lib) -> None:
    global _bamio_ready
    if _bamio_ready or lib is None:
        return
    c = ctypes
    lib.bamio_open.argtypes = [c.c_char_p]
    lib.bamio_open.restype = c.c_void_p
    lib.bamio_close.argtypes = [c.c_void_p]
    lib.bamio_header_len.argtypes = [c.c_void_p]
    lib.bamio_header_len.restype = c.c_longlong
    lib.bamio_header_text.argtypes = [c.c_void_p, c.c_char_p]
    lib.bamio_n_refs.argtypes = [c.c_void_p]
    lib.bamio_n_refs.restype = c.c_int
    lib.bamio_ref_name_len.argtypes = [c.c_void_p, c.c_int]
    lib.bamio_ref_name_len.restype = c.c_int
    lib.bamio_ref_name.argtypes = [c.c_void_p, c.c_int, c.c_char_p]
    lib.bamio_ref_len.argtypes = [c.c_void_p, c.c_int]
    lib.bamio_ref_len.restype = c.c_longlong
    lib.bamio_set_filter.argtypes = [c.c_void_p, c.c_int, c.c_int]
    lib.bamio_set_region.argtypes = [c.c_void_p, c.c_int, c.c_longlong,
                                     c.c_longlong]
    lib.bamio_rewind.argtypes = [c.c_void_p]
    lib.bamio_rewind.restype = c.c_int
    lib.bamio_seek_before.argtypes = [c.c_void_p, c.c_int, c.c_longlong]
    lib.bamio_seek_before.restype = c.c_int
    lib.bamio_sorted.argtypes = [c.c_void_p]
    lib.bamio_sorted.restype = c.c_int
    lib.bamio_error_len.argtypes = [c.c_void_p]
    lib.bamio_error_len.restype = c.c_longlong
    lib.bamio_error.argtypes = [c.c_void_p, c.c_char_p]
    lib.bamio_next_batch.argtypes = [c.c_void_p, c.c_longlong,
                                     c.POINTER(c.c_longlong), c.c_char_p,
                                     c.c_longlong]
    lib.bamio_next_batch.restype = c.c_longlong
    _bamio_ready = True


def native_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "bamio_open")


class NativeRead(SamRecord):
    """SamRecord plus precomputed realignment inputs from C++.

    ``aln`` is ``(int_ref, int_seq, expanded_cigar)`` when the native MD
    reconstruction succeeded, else None (caller falls back to the Python
    path / skip-with-warning).
    """

    def __init__(self, *args, aln=None, **kw):
        super().__init__(*args, **kw)
        self.aln = aln


class NativeBamReader:
    """Streaming BAM reader over native/bamio.cpp; BamReader-compatible."""

    BATCH = 512
    POOL = 32 << 20

    def __init__(self, path: str, prep: bool = True):
        if not os.path.exists(path):
            raise FileNotFoundError(f"BAM file '{path}' not found")
        lib = get_lib()
        if lib is None or not hasattr(lib, "bamio_open"):
            raise RuntimeError("native bamio not available")
        _bind(lib)
        self._lib = lib
        self.path = path
        self.prep = prep
        h = lib.bamio_open(path.encode())
        if not h:
            raise ValueError(f"'{path}' is not a BAM file")
        self._h = h
        n = lib.bamio_header_len(h)
        buf = ctypes.create_string_buffer(n)
        lib.bamio_header_text(h, buf)
        self.header_text = buf.raw[:n].decode("ascii", "replace")
        self.references: List[str] = []
        self.lengths: List[int] = []
        for i in range(lib.bamio_n_refs(h)):
            ln = lib.bamio_ref_name_len(h, i)
            nb = ctypes.create_string_buffer(ln)
            lib.bamio_ref_name(h, i, nb)
            self.references.append(nb.raw[:ln].decode("ascii"))
            self.lengths.append(lib.bamio_ref_len(h, i))
        self._fixed = np.empty((self.BATCH, _NF), dtype=np.int64)
        self._pool = ctypes.create_string_buffer(self.POOL)

    def close(self) -> None:
        if self._h:
            self._lib.bamio_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    def _error(self) -> str:
        n = self._lib.bamio_error_len(self._h)
        if not n:
            return ""
        buf = ctypes.create_string_buffer(n)
        self._lib.bamio_error(self._h, buf)
        return buf.raw[:n].decode("ascii", "replace")

    def _records(self) -> Iterator[NativeRead]:
        """Yield records from the current stream position until EOF (or
        until the in-C++ region filter stops the scan)."""
        lib = self._lib
        fixed_ptr = self._fixed.ctypes.data_as(
            ctypes.POINTER(ctypes.c_longlong))
        while True:
            n = lib.bamio_next_batch(self._h, self.BATCH, fixed_ptr,
                                     self._pool, self.POOL)
            if n < 0:
                raise ValueError(f"BAM stream error in '{self.path}': "
                                 f"{self._error() or n}")
            if n == 0:
                err = self._error()
                if err:
                    raise ValueError(
                        f"BAM stream error in '{self.path}': {err}")
                return
            # copy only the used pool extent (the C++ side bump-allocates,
            # so max offset+len across fields bounds it); .raw would copy
            # the whole 32MB cap per batch
            fx = self._fixed
            fxv = fx[:int(n)]
            used = 0
            for off, ln in ((8, 9), (10, 11), (14, 15), (16, 17),
                            (18, 19), (20, 21)):
                used = max(used, int((fxv[:, off] + fxv[:, ln]).max()))
            used = max(used, int((fxv[:, 12] + fxv[:, 7]).max()))
            q = np.where(fxv[:, 13] >= 0, fxv[:, 13] + fxv[:, 7], 0)
            used = max(used, int(q.max()))
            pool = ctypes.string_at(self._pool, used)
            refs = self.references
            for i in range(int(n)):
                f = fx[i]
                qname = pool[f[8]:f[8] + f[9]].decode("ascii")
                cigar = pool[f[10]:f[10] + f[11]].decode("ascii")
                l_seq = int(f[7])
                seq = pool[f[12]:f[12] + l_seq].decode("ascii") \
                    if l_seq else "*"
                qual = pool[f[13]:f[13] + l_seq].decode("ascii") \
                    if f[13] >= 0 else "*"
                tags_txt = pool[f[14]:f[14] + f[15]].decode("ascii")
                tags = dict(parse_tag(t) for t in tags_txt.split("\t")) \
                    if tags_txt else {}
                ref_id = int(f[1])
                next_ref = int(f[4])
                aln = None
                if self.prep and not f[22]:
                    # uint8 like constants.bases_to_int produces
                    int_ref = np.frombuffer(
                        pool, dtype=np.uint8, count=int(f[17]),
                        offset=int(f[16])).copy()
                    int_seq = np.frombuffer(
                        pool, dtype=np.uint8, count=int(f[19]),
                        offset=int(f[18])).copy()
                    ecig = pool[f[20]:f[20] + f[21]].decode("ascii")
                    aln = (int_ref, int_seq, ecig)
                yield NativeRead(
                    qname=qname, flag=int(f[0]),
                    rname=refs[ref_id] if ref_id >= 0 else "*",
                    pos=int(f[2]), mapq=int(f[3]), cigar=cigar,
                    rnext=("*" if next_ref < 0 else
                           ("=" if next_ref == ref_id else refs[next_ref])),
                    pnext=int(f[5]) + 1 if next_ref >= 0 else 0,
                    tlen=int(f[6]), seq=seq, qual=qual, tags=tags,
                    aln=aln)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[NativeRead]:
        self._lib.bamio_set_region(self._h, -2, -1, -1)
        self._lib.bamio_set_filter(self._h, _EXCL_DEFAULT,
                                   1 if self.prep else 0)
        if self._lib.bamio_rewind(self._h) != 0:
            raise ValueError(f"BAM rewind failed: {self._error()}")
        return self._records()

    def fetch(self, contig: Optional[str] = None,
              start: Optional[int] = None,
              stop: Optional[int] = None) -> Iterator[NativeRead]:
        """Region fetch; seeks via the sparse index on sorted BAMs.

        Mirrors io/bam.BamReader.fetch semantics (unmapped reads appear
        only in the contig-less full scan)."""
        if contig is None:
            yield from iter(self)
            return
        if contig not in self.references:
            return
        rid = self.references.index(contig)
        lib = self._lib
        lib.bamio_set_filter(self._h, _EXCL_DEFAULT, 1 if self.prep else 0)
        lib.bamio_set_region(self._h, rid,
                             -1 if start is None else start,
                             -1 if stop is None else stop)
        if lib.bamio_seek_before(self._h, rid,
                                 0 if start is None else start) != 0:
            raise ValueError(f"BAM seek failed: {self._error()}")
        try:
            yield from self._records()
        finally:
            lib.bamio_set_region(self._h, -2, -1, -1)

    def count(self, contig: str, start: int, stop: int) -> int:
        return sum(1 for _ in self.fetch(contig, start, stop))
