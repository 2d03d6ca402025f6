"""BGZF block writer + tabix (.tbi) index generator.

The reference shells out to ``bgzip`` and ``tabix -p vcf`` for every VCF it
emits (reference: src/vcf.py:132-133, 422-424; src/standardize_vcf.py:42).
Neither tool exists in this image, so both formats are produced in-process:

* BGZF (SAM spec section 4.1): a series of gzip members, each with the
  two-byte ``BC`` extra field holding the total block size, at most 64 KiB
  of uncompressed payload per block, terminated by the fixed 28-byte EOF
  marker block. Plain ``gzip`` readers (including this repo's VcfReader
  and io/bam.py) consume it transparently as concatenated members.
* Tabix (.tbi, samtools tabix spec): the R-tree binning index + 16 kb
  linear index over BGZF virtual file offsets, VCF preset (format=2,
  seq/beg cols 1/2, meta '#').
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_MAX_BLOCK = 65280          # uncompressed payload per block (htslib value)


def _deflate_block(payload: bytes) -> bytes:
    """One BGZF block: gzip member with BC extra subfield."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = c.compress(payload) + c.flush()
    bsize = len(comp) + 25 + 1          # header(12+6) + comp + crc/isize(8)
    header = struct.pack(
        "<4BI2BH2B2H",
        0x1F, 0x8B, 0x08, 0x04,         # magic, CM=deflate, FLG.FEXTRA
        0,                              # MTIME
        0, 0xFF,                        # XFL, OS=unknown
        6,                              # XLEN
        0x42, 0x43,                     # 'B' 'C'
        2,                              # subfield length
        bsize - 1)                      # BSIZE - 1
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                         len(payload) & 0xFFFFFFFF)
    return header + comp + footer


class BgzfWriter:
    """Streaming BGZF writer tracking virtual file offsets.

    ``tell()`` returns the BGZF *virtual offset* ``(coffset << 16) | uoffset``
    of the next byte to be written — the currency of tabix indexes.
    """

    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._coffset = 0               # compressed bytes flushed so far

    def tell(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data) -> None:
        if isinstance(data, str):
            data = data.encode("ascii")
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._flush_block(self._buf[:_MAX_BLOCK])
            del self._buf[:_MAX_BLOCK]

    def _flush_block(self, payload: bytes) -> None:
        blk = _deflate_block(bytes(payload))
        self._fh.write(blk)
        self._coffset += len(blk)

    def close(self) -> None:
        if self._fh is None:
            return
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def bgzf_compress(data: bytes) -> bytes:
    """Whole-buffer BGZF compression (with EOF marker)."""
    out = []
    for i in range(0, len(data), _MAX_BLOCK):
        out.append(_deflate_block(data[i:i + _MAX_BLOCK]))
    out.append(BGZF_EOF)
    return b"".join(out)


# ---------------------------------------------------------------------------
# tabix
# ---------------------------------------------------------------------------

def reg2bin(beg: int, end: int) -> int:
    """UCSC binning: smallest bin containing [beg, end)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end) (tabix spec reg2bins)."""
    bins = [0]
    end -= 1
    for shift, off in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return bins


class _TbiBuilder:
    """Accumulates (contig, beg, end, voff_start, voff_end) per record."""

    def __init__(self):
        self.names: List[str] = []
        self._idx: Dict[str, int] = {}
        # per ref: {bin: [(voff_beg, voff_end), ...]}, linear [voffs]
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[List[int]] = []
        self.n_no_coor = 0

    def add(self, contig: str, beg: int, end: int,
            v_beg: int, v_end: int) -> None:
        if contig not in self._idx:
            self._idx[contig] = len(self.names)
            self.names.append(contig)
            self.bins.append({})
            self.linear.append([])
        ri = self._idx[contig]
        b = reg2bin(beg, max(end, beg + 1))
        chunks = self.bins[ri].setdefault(b, [])
        # merge adjacent chunks (htslib-style) to keep the index small
        if chunks and chunks[-1][1] == v_beg:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_beg, v_end))
        lin = self.linear[ri]
        w_end = max(end - 1, beg) >> 14
        while len(lin) <= w_end:
            lin.append(0)
        for w in range(beg >> 14, w_end + 1):
            if lin[w] == 0:
                lin[w] = v_beg

    def serialize(self, preset: int = 2, col_seq: int = 1, col_beg: int = 2,
                  col_end: int = 0, meta: str = "#", skip: int = 0) -> bytes:
        out = [b"TBI\x01"]
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        out.append(struct.pack("<8i", len(self.names), preset, col_seq,
                               col_beg, col_end, ord(meta), skip,
                               len(names_blob)))
        out.append(names_blob)
        for ri in range(len(self.names)):
            bins = self.bins[ri]
            out.append(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                chunks = bins[b]
                out.append(struct.pack("<Ii", b, len(chunks)))
                for v0, v1 in chunks:
                    out.append(struct.pack("<QQ", v0, v1))
            lin = self.linear[ri]
            # fill leading/interior zeros with the previous offset
            filled = []
            prev = 0
            for v in lin:
                prev = v if v else prev
                filled.append(prev)
            out.append(struct.pack("<i", len(filled)))
            for v in filled:
                out.append(struct.pack("<Q", v))
        out.append(struct.pack("<Q", self.n_no_coor))
        return b"".join(out)


def write_bgzip_vcf(path: str, header_lines, records) -> str:
    """Write records as BGZF-compressed VCF + .tbi (bgzip+tabix parity,
    reference: src/vcf.py:132-133, 422-424). ``records`` need ``.contig``,
    ``.pos`` (0-based), ``.stop`` and ``.to_line()``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tbi = _TbiBuilder()
    with BgzfWriter(path) as w:
        for line in header_lines:
            w.write(line + "\n")
        for rec in records:
            v0 = w.tell()
            w.write(rec.to_line() + "\n")
            tbi.add(rec.contig, rec.pos, rec.stop, v0, w.tell())
    with open(path + ".tbi", "wb") as fh:
        fh.write(bgzf_compress(tbi.serialize()))
    return path


# ---------------------------------------------------------------------------
# reading side (used by tests and region fetches on indexed VCFs)
# ---------------------------------------------------------------------------

def read_tabix(path: str):
    """Parse a .tbi file -> (names, {ref_i: {bin: [(v0, v1)]}}, linear)."""
    import gzip
    with gzip.open(path, "rb") as fh:
        data = fh.read()
    assert data[:4] == b"TBI\x01", "not a tabix index"
    n_ref, preset, c_seq, c_beg, c_end, meta, skip, l_nm = struct.unpack_from(
        "<8i", data, 4)
    off = 36
    blob = data[off:off + l_nm]
    names = [n.decode() for n in blob.split(b"\x00") if n]
    off += l_nm
    bins_all = []
    linear_all = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                v0, v1 = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((v0, v1))
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        lin = list(struct.unpack_from(f"<{n_intv}Q", data, off))
        off += 8 * n_intv
        bins_all.append(bins)
        linear_all.append(lin)
    return names, bins_all, linear_all


def bgzf_read_at(path: str, voff: int, length: int = 1 << 16) -> bytes:
    """Read decompressed bytes starting at a BGZF virtual offset."""
    coff = voff >> 16
    uoff = voff & 0xFFFF
    out = b""
    with open(path, "rb") as fh:
        fh.seek(coff)
        while len(out) < uoff + length:
            hdr = fh.read(18)
            if len(hdr) < 18:
                break
            bsize = struct.unpack_from("<H", hdr, 16)[0] + 1
            comp = hdr + fh.read(bsize - 18)
            # layout: 10B gzip header + 2B XLEN + 6B BC extra, deflate
            # stream, 8B crc32+isize
            payload = zlib.decompress(comp[18:bsize - 8], -15)
            if not payload:
                break
            out += payload
    return out[uoff:uoff + length]


def tabix_fetch_lines(vcf_gz: str, contig: str, beg: int,
                      end: int) -> Iterator[str]:
    """Indexed region query over a bgzipped VCF via its .tbi."""
    names, bins_all, linear_all = read_tabix(vcf_gz + ".tbi")
    if contig not in names:
        return
    ri = names.index(contig)
    bins = bins_all[ri]
    lin = linear_all[ri]
    min_v = lin[min(beg >> 14, len(lin) - 1)] if lin else 0
    chunks = []
    for b in reg2bins(beg, end):
        for v0, v1 in bins.get(b, []):
            if v1 > min_v:
                chunks.append((max(v0, min_v), v1))
    seen = set()
    for v0, v1 in sorted(chunks):
        # decompress generously past v1 so the final line is complete
        blob = bgzf_read_at(vcf_gz, v0, ((v1 >> 16) - (v0 >> 16))
                            + (v1 & 0xFFFF) - (v0 & 0xFFFF) + (1 << 17))
        for line in blob.split(b"\n"):
            if not line or line.startswith(b"#"):
                continue
            f = line.split(b"\t", 3)
            if len(f) < 3:
                continue
            try:
                pos = int(f[1]) - 1
            except ValueError:
                continue
            if f[0].decode() != contig or pos >= end:
                break
            key = (f[0], f[1], f[2] if len(f) > 2 else b"")
            if pos >= beg and key not in seen:
                seen.add(key)
                yield line.decode()
