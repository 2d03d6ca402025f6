"""FASTA, BGZF and BAM writing for the benchmark's inputs: a frozen copy of
the port's ``io/fasta.write_fasta``, ``io/bgzf.BgzfWriter`` and
``io/bam_writer.write_bam``, with the per-base loops of the record encoder
done in numpy. The bytes written are the same
(``benchmark/tests/test_bench_traffic.py`` holds them so)."""
from __future__ import annotations

import re
import struct
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_MAX_BLOCK = 65280          # uncompressed payload per block (htslib value)

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=XB])")
_CIG_OP = {op: i for i, op in enumerate("MIDNSHP=X")}
_CONSUMES_REF = frozenset("MDN=X")
_NIBBLE = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate("=ACMGRSVTWYHKDBN"):
    _NIBBLE[ord(_b)] = _i
    _NIBBLE[ord(_b.lower())] = _i


def write_fasta(path: str, contigs: Dict[str, str], width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")


def collapse_cigar(extended: str) -> str:
    """'DMMMII' -> '1D3M2I'."""
    if not extended:
        return ""
    b = np.frombuffer(extended.encode("ascii"), dtype=np.uint8)
    starts = np.concatenate(([0], np.flatnonzero(b[1:] != b[:-1]) + 1))
    lens = np.diff(np.concatenate((starts, [len(b)])))
    return "".join(map("".join, zip(lens.astype(str).tolist(),
                                    b[starts].tobytes().decode("ascii"))))


def cigar_tuples(cigar: str) -> List[Tuple[int, str]]:
    return [(int(n), op) for n, op in _CIGAR_RE.findall(cigar)]


def _deflate_block(payload: bytes) -> bytes:
    """One BGZF block: a gzip member with the BC extra subfield."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = c.compress(payload) + c.flush()
    bsize = len(comp) + 25 + 1
    header = struct.pack("<4BI2BH2B2H", 0x1F, 0x8B, 0x08, 0x04, 0, 0, 0xFF,
                         6, 0x42, 0x43, 2, bsize - 1)
    footer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                         len(payload) & 0xFFFFFFFF)
    return header + comp + footer


class BgzfWriter:
    def __init__(self, path: str):
        self._fh = open(path, "wb")
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            self._fh.write(_deflate_block(bytes(self._buf[:_MAX_BLOCK])))
            del self._buf[:_MAX_BLOCK]

    def close(self) -> None:
        if self._buf:
            self._fh.write(_deflate_block(bytes(self._buf)))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning: the smallest bin holding [beg, end)."""
    end -= 1
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return off + (beg >> shift)
    return 0


def encode_record(qname: str, flag: int, rname: str, pos: int, mapq: int,
                  cigar: str, seq: str, qual: str,
                  tags: Dict[str, Tuple[str, object]],
                  ref_ids: Dict[str, int]) -> bytes:
    """One BAM record (SAM spec 4.2); RNEXT '*', PNEXT 0, TLEN 0."""
    ref_id = ref_ids.get(rname, -1)
    if rname == "*":
        ref_id, pos = -1, -1
    name = qname.encode("ascii") + b"\x00"
    tups = [] if cigar == "*" else cigar_tuples(cigar)
    cig = np.array([(n << 4) | _CIG_OP[op] for n, op in tups],
                   dtype="<u4").tobytes()
    seq = seq if seq != "*" else ""
    l_seq = len(seq)
    nib = _NIBBLE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if l_seq % 2:
        nib = np.append(nib, np.uint8(0))
    sq = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
    if qual == "*" or not l_seq:
        qb = b"\xff" * l_seq
    else:
        if len(qual) != l_seq:
            raise ValueError(f"qual/seq length mismatch for {qname}")
        qb = (np.frombuffer(qual.encode("ascii"), dtype=np.uint8)
              - np.uint8(33)).tobytes()
    ref_len = sum(n for n, op in tups if op in _CONSUMES_REF)
    end = pos + ref_len if tups else pos + 1
    bam_bin = reg2bin(max(pos, 0), max(end, pos + 1)) if ref_id >= 0 else 0
    tb = bytearray()
    for tag, (typ, val) in tags.items():
        tb += tag.encode("ascii")
        if typ == "i":
            tb += b"i" + struct.pack("<i", int(val))
        elif typ in ("Z", "H"):
            tb += typ.encode("ascii") + str(val).encode("ascii") + b"\x00"
        else:
            raise ValueError(f"unsupported tag type '{typ}' for {tag}")
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(name), mapq, bam_bin,
                       len(tups), flag, l_seq, -1, -1, 0)
    body += name + cig + sq + qb + bytes(tb)
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, references: Sequence[str], lengths: Sequence[int],
              records: Iterable[tuple], header_text: Optional[str] = None
              ) -> None:
    """A BAM of ``records``: tuples of ``encode_record``'s first eight
    arguments, coordinate-sorted."""
    ref_ids = {n: i for i, n in enumerate(references)}
    with BgzfWriter(path) as w:
        text = header_text.encode("ascii")
        w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        w.write(struct.pack("<i", len(references)))
        for n, ln in zip(references, lengths):
            nb = n.encode("ascii") + b"\x00"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
        for rec in records:
            w.write(encode_record(*rec, ref_ids=ref_ids))
