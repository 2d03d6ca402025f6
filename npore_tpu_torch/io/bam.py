"""BAM binary reader: BGZF decompression + record decoding.

Replaces pysam.AlignmentFile for reading (reference: src/bam.pyx:21,
src/util.py:25). BGZF is a sequence of concatenated gzip members, which
zlib handles directly; records are decoded per the SAM spec section 4.2
into the same SamRecord structure the SAM text reader produces, so the
rest of the framework is container-agnostic.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

from .sam import SamRecord
from ..constants import BAM_SEQ_CODES, CIGARS


def _bgzf_decompress(data: bytes) -> bytes:
    """Decompress concatenated gzip members (BGZF blocks)."""
    out = []
    d = zlib.decompressobj(wbits=31)
    buf = data
    while buf:
        out.append(d.decompress(buf))
        buf = d.unused_data
        if not d.eof:
            break
        d = zlib.decompressobj(wbits=31)
    return b"".join(out)


_TAG_FMT = {
    "c": ("b", 1), "C": ("B", 1), "s": ("h", 2), "S": ("H", 2),
    "i": ("i", 4), "I": ("I", 4), "f": ("f", 4),
}
_TAG_SAM_TYPE = {"c": "i", "C": "i", "s": "i", "S": "i", "i": "i", "I": "i",
                 "f": "f", "A": "A", "Z": "Z", "H": "H", "B": "B"}


def _decode_tags(buf: bytes) -> dict:
    tags = {}
    i = 0
    n = len(buf)
    while i + 3 <= n:
        tag = buf[i:i + 2].decode("ascii")
        typ = chr(buf[i + 2])
        i += 3
        if typ in _TAG_FMT:
            fmt, size = _TAG_FMT[typ]
            val = struct.unpack_from("<" + fmt, buf, i)[0]
            i += size
        elif typ == "A":
            val = chr(buf[i])
            i += 1
        elif typ in ("Z", "H"):
            end = buf.index(0, i)
            val = buf[i:end].decode("ascii")
            i = end + 1
        elif typ == "B":
            sub = chr(buf[i])
            cnt = struct.unpack_from("<I", buf, i + 1)[0]
            fmt, size = _TAG_FMT[sub]
            val = list(struct.unpack_from(f"<{cnt}{fmt}", buf, i + 5))
            i += 5 + cnt * size
        else:
            raise ValueError(f"unknown BAM tag type {typ!r}")
        tags[tag] = (_TAG_SAM_TYPE[typ], val)
    return tags


class BamReader:
    """Reads a whole BAM into memory and iterates SamRecords.

    Note on ordering/regions: like the reference's usage (sequential fetch
    over regions, src/bam.pyx:27-28), we linear-scan; .bai indexes are not
    required because realignment streams every read exactly once.
    """

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(f"BAM file '{path}' not found")
        self.path = path
        with open(path, "rb") as fh:
            raw = fh.read()
        data = _bgzf_decompress(raw)
        if data[:4] != b"BAM\x01":
            raise ValueError(f"'{path}' is not a BAM file")
        try:
            (l_text,) = struct.unpack_from("<i", data, 4)
            off = 8
            self.header_text = data[off:off + l_text].decode("ascii",
                                                             "replace")
            off += l_text
            (n_ref,) = struct.unpack_from("<i", data, off)
            off += 4
            self.references: List[str] = []
            self.lengths: List[int] = []
            for _ in range(n_ref):
                (l_name,) = struct.unpack_from("<i", data, off)
                off += 4
                self.references.append(
                    data[off:off + l_name - 1].decode("ascii"))
                off += l_name
                (l_ref,) = struct.unpack_from("<i", data, off)
                off += 4
                self.lengths.append(l_ref)
        except struct.error as e:
            raise ValueError(
                f"truncated or corrupt BAM header in '{path}': {e}") from e
        self._data = data
        self._records_offset = off

    def __iter__(self) -> Iterator[SamRecord]:
        data = self._data
        off = self._records_offset
        n = len(data)
        refs = self.references
        while off + 4 <= n:
            (block_size,) = struct.unpack_from("<i", data, off)
            off += 4
            rec_end = off + block_size
            if rec_end > n:
                raise ValueError(
                    f"truncated BAM record stream in '{self.path}' at "
                    f"offset {off - 4}")
            (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
             next_ref_id, next_pos, tlen) = struct.unpack_from(
                "<iiBBHHHiiii", data, off)
            p = off + 32
            qname = data[p:p + l_read_name - 1].decode("ascii")
            p += l_read_name
            cig_ops = struct.unpack_from(f"<{n_cigar_op}I", data, p)
            p += 4 * n_cigar_op
            cigar = "".join(f"{op >> 4}{CIGARS[op & 0xF]}" for op in cig_ops) \
                if n_cigar_op else "*"
            nbytes = (l_seq + 1) // 2
            seq_enc = data[p:p + nbytes]
            p += nbytes
            chars = []
            for b in seq_enc:
                chars.append(BAM_SEQ_CODES[b >> 4])
                chars.append(BAM_SEQ_CODES[b & 0xF])
            seq = "".join(chars[:l_seq]) if l_seq else "*"
            qual_raw = data[p:p + l_seq]
            p += l_seq
            if l_seq and qual_raw and qual_raw[0] != 0xFF:
                qual = "".join(chr(33 + q) for q in qual_raw)
            else:
                qual = "*"
            tags = _decode_tags(data[p:rec_end])
            off = rec_end
            yield SamRecord(
                qname=qname, flag=flag,
                rname=refs[ref_id] if ref_id >= 0 else "*",
                pos=pos, mapq=mapq, cigar=cigar,
                rnext=("*" if next_ref_id < 0 else
                       ("=" if next_ref_id == ref_id else refs[next_ref_id])),
                pnext=next_pos + 1 if next_ref_id >= 0 else 0,
                tlen=tlen, seq=seq, qual=qual, tags=tags)

    def fetch(self, contig: Optional[str] = None, start: Optional[int] = None,
              stop: Optional[int] = None) -> Iterator[SamRecord]:
        for rec in self:
            if contig is not None and rec.rname != contig:
                continue
            if rec.is_unmapped:
                if contig is None:
                    yield rec
                continue
            if start is not None and rec.reference_end <= start:
                continue
            if stop is not None and rec.pos > stop:
                continue
            yield rec

    def count(self, contig: str, start: int, stop: int) -> int:
        return sum(1 for _ in self.fetch(contig, start, stop))


def open_alignment_file(path: str, prep: bool = True):
    """Open a BAM or SAM by extension (pysam.AlignmentFile parity).

    BAMs go through the C++ streaming decoder (io/bam_native.py) when the
    native library is available — bounded memory, indexed region seeks,
    and (with ``prep``) per-record realignment inputs computed natively —
    falling back to this module's pure-Python reader otherwise."""
    if path.endswith(".bam"):
        try:
            from .bam_native import NativeBamReader
            return NativeBamReader(path, prep=prep)
        except Exception:
            return BamReader(path)
    from .sam import SamReader
    return SamReader(path)
