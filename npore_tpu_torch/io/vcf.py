"""VCF toolbox: records, IO, haplotype split/apply/gen/merge, overlap filter.

Replaces the reference's pysam.VariantFile pipeline (reference: src/vcf.py)
without pysam: VCF text IO plus in-process bgzip/tabix (io/bgzf.py), so
``.vcf.gz`` outputs ship with ``.tbi`` indexes exactly like the reference's
subprocess calls produce (src/vcf.py:132-133, 422-424). The port's copy
of ``npore_tpu/io/vcf.py``.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class VcfRecord:
    contig: str
    pos: int                  # 0-based start (pysam .start)
    id: str
    alleles: Tuple[str, ...]  # (ref, alt1[, alt2])
    qual: Optional[float]
    filter: str
    info: str
    fmt: str = "GT"
    sample: str = "."

    @property
    def start(self) -> int:
        return self.pos

    @property
    def stop(self) -> int:
        """End on the reference (pysam .stop): start + len(REF)."""
        return self.pos + len(self.alleles[0])

    @property
    def gt(self) -> Tuple[Optional[int], ...]:
        """Genotype tuple from the first sample (None for '.')."""
        if self.fmt.split(":")[0] != "GT" or self.sample in (".", ""):
            return (None,)
        gt_str = self.sample.split(":")[0]
        sep = "|" if "|" in gt_str else "/"
        out = []
        for tok in gt_str.split(sep):
            out.append(None if tok == "." else int(tok))
        return tuple(out)

    def sample_field(self, key: str) -> Optional[str]:
        keys = self.fmt.split(":")
        vals = self.sample.split(":")
        if key in keys and len(vals) > keys.index(key):
            return vals[keys.index(key)]
        return None

    def with_(self, **kw) -> "VcfRecord":
        return dataclasses.replace(self, **kw)

    def to_line(self) -> str:
        alt = ",".join(self.alleles[1:]) if len(self.alleles) > 1 else "."
        q = "." if self.qual is None else (
            str(int(self.qual)) if float(self.qual).is_integer()
            else f"{self.qual:g}")
        return "\t".join([self.contig, str(self.pos + 1), self.id,
                          self.alleles[0], alt, q, self.filter, self.info,
                          self.fmt, self.sample])


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class VcfReader:
    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(f"VCF file '{path}' not found")
        self.path = path
        self.header_lines: List[str] = []
        self.contigs: List[str] = []
        self.contig_lengths: Dict[str, int] = {}
        with _open(path) as fh:
            for line in fh:
                if not line.startswith("#"):
                    break
                self.header_lines.append(line.rstrip("\n"))
                if line.startswith("##contig"):
                    body = line.split("<", 1)[1].rstrip(">\n")
                    d = dict(x.split("=", 1) for x in body.split(","))
                    self.contigs.append(d["ID"])
                    if "length" in d:
                        self.contig_lengths[d["ID"]] = int(d["length"])

    def __iter__(self) -> Iterator[VcfRecord]:
        with _open(self.path) as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                yield parse_vcf_line(line)

    def fetch(self, contig: Optional[str] = None, start: Optional[int] = None,
              stop: Optional[int] = None) -> Iterator[VcfRecord]:
        for rec in self:
            if contig is not None and rec.contig != contig:
                continue
            if start is not None and rec.stop <= start:
                continue
            if stop is not None and rec.pos >= stop:
                continue
            yield rec


def parse_vcf_line(line: str) -> VcfRecord:
    f = line.rstrip("\n").split("\t")
    alts = tuple(f[4].split(",")) if f[4] != "." else ()
    return VcfRecord(
        contig=f[0], pos=int(f[1]) - 1, id=f[2],
        alleles=(f[3],) + alts,
        qual=None if f[5] == "." else float(f[5]),
        filter=f[6] if len(f) > 6 else ".",
        info=f[7] if len(f) > 7 else ".",
        fmt=f[8] if len(f) > 8 else "GT",
        sample=f[9] if len(f) > 9 else ".")


def write_vcf(path: str, header_lines: Sequence[str],
              records: Iterable[VcfRecord]) -> str:
    """Write a VCF; ``.gz`` paths get in-process bgzip + a .tbi index
    (reference: src/vcf.py:132-133, 422-424 shells out to bgzip/tabix)."""
    if path.endswith(".gz"):
        from .bgzf import write_bgzip_vcf
        return write_bgzip_vcf(path, header_lines, records)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for line in header_lines:
            fh.write(line + "\n")
        for rec in records:
            fh.write(rec.to_line() + "\n")
    return path


def make_header(contigs: Sequence[Tuple[str, Optional[int]]]) -> List[str]:
    """Minimal standardize-vcf output header (reference: src/vcf.py:273-291,
    407-411 -- contig lines carry lengths after the header surgery)."""
    lines = ["##fileformat=VCFv4.2"]
    for ctg, ln in contigs:
        if ln is None:
            lines.append(f"##contig=<ID={ctg}>")
        else:
            lines.append(f"##contig=<ID={ctg},length={ln}>")
    lines.append('##FORMAT=<ID=GT,Number=1,Type=String,'
                 'Description="Genotype">')
    lines.append('##FORMAT=<ID=GQ,Number=1,Type=Integer,'
                 'Description="Genotype quality score">')
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                 "\tSAMPLE")
    return lines


# ---------------------------------------------------------------------------
# toolbox (reference: src/vcf.py)
# ---------------------------------------------------------------------------

def filter_overlaps(in_vcf_fn: str, out_vcf_fn: str) -> None:
    """Drop variants overlapping the reference span of a previous record
    (reference: src/vcf.py:10-32)."""
    vcf = VcfReader(in_vcf_fn)
    prev_contig = ""
    prev_stop = 0
    kept = []
    for rec in vcf:
        if rec.contig != prev_contig:
            prev_stop = 0
            prev_contig = rec.contig
        if rec.start < prev_stop:
            continue
        kept.append(rec)
        prev_stop = rec.stop
    write_vcf(out_vcf_fn, vcf.header_lines, kept)


def filter_gt(in_vcf_fn: str, out_vcf_fn: str, exclude_gt: str) -> int:
    """Drop records whose genotype call equals ``exclude_gt`` — in-process
    form of the pipeline's ``bcftools filter --exclude 'GT="0/0"'`` passes
    (reference: scripts/realign_pipeline.sh:277-279, 409-411). Unphased
    and phased separators compare equal (bcftools GT semantics). Returns
    the number of records kept."""
    want = tuple(sorted(exclude_gt.replace("|", "/").split("/")))
    vcf = VcfReader(in_vcf_fn)
    kept = []
    for rec in vcf:
        gt = rec.sample.split(":", 1)[0].replace("|", "/")
        if tuple(sorted(gt.split("/"))) == want:
            continue
        kept.append(rec)
    write_vcf(out_vcf_fn, vcf.header_lines, kept)
    return len(kept)


def split_vcf(vcf_fn: str, regions: Sequence[Tuple[str, int, int]],
              out_pre: str = "", filter_unphased: bool = False
              ) -> Tuple[str, str]:
    """Split a phased diploid VCF into two haploid VCFs
    (reference: src/vcf.py:36-135)."""
    vcf = VcfReader(vcf_fn)
    recs1: List[VcfRecord] = []
    recs2: List[VcfRecord] = []
    unphased = True
    any_records = False

    def strip_gt(rec: VcfRecord, alleles=None) -> VcfRecord:
        return rec.with_(alleles=alleles or rec.alleles, fmt="GT", sample=".")

    for ctg, start, stop in regions:
        for rec in vcf.fetch(ctg, start, stop):
            any_records = True
            gt = rec.gt
            if len(gt) < 2:
                gt = (gt[0], gt[0])
            g0 = gt[0] or 0
            g1 = gt[1] or 0
            if len(rec.alleles) == 3:       # multi-allelic: different variants
                if rec.alleles[g0] != "*":
                    recs1.append(strip_gt(
                        rec, (rec.alleles[0], rec.alleles[g0])))
                if rec.alleles[g1] != "*":
                    recs2.append(strip_gt(
                        rec, (rec.alleles[0], rec.alleles[g1])))
            elif g0 and g1:                 # hom-alt
                recs1.append(strip_gt(rec))
                recs2.append(strip_gt(rec))
            elif g0:
                if filter_unphased and rec.sample_field("PS") is None:
                    continue
                recs1.append(strip_gt(rec))
            elif g1:
                if filter_unphased and rec.sample_field("PS") is None:
                    continue
                recs2.append(strip_gt(rec))
            elif not g0 and not g1 and len(rec.alleles) > 1 \
                    and rec.alleles[0] == rec.alleles[1]:
                pass
            else:
                # 0/0 or malformed: reference treats as hom variant
                if len(rec.alleles) > 1:
                    recs1.append(strip_gt(rec))
                    recs2.append(strip_gt(rec))
            if g0 and not g1:
                unphased = False

    if not any_records:
        print("\nWARNING: VCF file has no variants in selected region.")
    elif unphased:
        print("\nWARNING: VCF file may be unphased.")

    fn1 = write_vcf(out_pre + "1.vcf.gz", vcf.header_lines, recs1)
    fn2 = write_vcf(out_pre + "2.vcf.gz", vcf.header_lines, recs2)
    return fn1, fn2


def merge_vcfs(vcf_fn1: str, vcf_fn2: str, out_fn: str,
               regions: Sequence[Tuple[str, int, int]]) -> str:
    """Two-pointer merge of haploid VCFs into a diploid VCF with
    1|0 / 0|1 / 1|1 genotypes (reference: src/vcf.py:139-205)."""
    v1 = VcfReader(vcf_fn1)
    v2 = VcfReader(vcf_fn2)
    out: List[VcfRecord] = []
    for ctg, start, stop in regions:
        it1 = iter(v1.fetch(ctg, start, stop))
        it2 = iter(v2.fetch(ctg, start, stop))
        r1 = next(it1, None)
        r2 = next(it2, None)
        while r1 or r2:
            p1 = float("inf") if r1 is None else r1.pos
            p2 = float("inf") if r2 is None else r2.pos
            p = min(p1, p2)
            h1 = p1 == p
            h2 = p2 == p
            if h1 and h2:
                if r1.alleles == r2.alleles:
                    out.append(r1.with_(fmt="GT", sample="1|1"))
                else:
                    out.append(r1.with_(fmt="GT", sample="1|0"))
                    out.append(r2.with_(fmt="GT", sample="0|1"))
            elif h1:
                out.append(r1.with_(fmt="GT", sample="1|0"))
            elif h2:
                out.append(r2.with_(fmt="GT", sample="0|1"))
            if h1:
                r1 = next(it1, None)
            if h2:
                r2 = next(it2, None)
    return write_vcf(out_fn, v1.header_lines, out)


def apply_vcf(vcf_fn: str, hap: int,
              regions: Sequence[Tuple[str, int, int]],
              get_ref, min_qual: int = 0) -> List[Tuple]:
    """Synthesize each region's haplotype sequence + extended CIGAR vs the
    reference FASTA (reference: src/vcf.py:209-269). ``get_ref(ctg)``
    returns the full contig string."""
    vcf = VcfReader(vcf_fn)
    data = []
    for contig, start, stop in regions:
        cig: List[str] = []
        seq: List[str] = []
        ref = get_ref(contig)
        ref_ptr = 0
        for rec in vcf.fetch(contig, start, stop):
            pos = rec.pos
            if min_qual and (rec.qual is None or rec.qual < min_qual):
                continue
            if pos < ref_ptr:   # overlaps previous DEL
                indel_len = len(rec.alleles[1]) - len(rec.alleles[0])
                if indel_len > 0:
                    seq.append(rec.alleles[1][len(rec.alleles[0]):])
                    cig.append("I" * indel_len)
                elif indel_len < 0 and pos == ref_ptr - 1:
                    indel_len = -indel_len
                    cig.append("D" * indel_len)
                    ref_ptr += indel_len
                continue
            seq.append(ref[ref_ptr:pos])
            cig.append("=" * (pos - ref_ptr))
            ref_ptr = pos

            seq.append(rec.alleles[1])
            minlen = min(len(rec.alleles[0]), len(rec.alleles[1]))
            for i in range(minlen):
                cig.append("=" if rec.alleles[0][i] == rec.alleles[1][i]
                           else "X")
                ref_ptr += 1
            indel_len = len(rec.alleles[1]) - len(rec.alleles[0])
            if indel_len > 0:
                cig.append("I" * indel_len)
            elif indel_len < 0:
                cig.append("D" * (-indel_len))
                ref_ptr += -indel_len
        cig.append("=" * (len(ref) - ref_ptr))
        seq.append(ref[ref_ptr:])
        data.append((contig, hap, "".join(seq), ref, "".join(cig)))
    return data


def gen_vcf(hap_data: Sequence[Tuple], hap: int, out_pre: str = "") -> str:
    """Convert realigned whole-contig CIGARs back into a haploid VCF
    (reference: src/vcf.py:273-426, incl. the header surgery that injects
    contig lengths and the END=0 cleanup -- moot here since INFO is '.')."""
    records: List[VcfRecord] = []
    contigs: List[Tuple[str, int]] = []
    for contig, _hap, seq, ref, cigar in hap_data:
        contigs.append((contig, len(ref)))
        ref_ptr = 0
        seq_ptr = 0
        i = 0
        n = len(cigar)
        while i < n:
            op = cigar[i]
            if op == "=":
                ref_ptr += 1
                seq_ptr += 1
                i += 1
            elif op == "X" or (op == "M" and ref[ref_ptr] != seq[seq_ptr]):
                records.append(VcfRecord(
                    contig=contig, pos=ref_ptr, id=".",
                    alleles=(ref[ref_ptr], seq[seq_ptr]), qual=60,
                    filter="PASS", info=".", fmt="GT", sample="."))
                ref_ptr += 1
                seq_ptr += 1
                i += 1
            elif op == "M":
                ref_ptr += 1
                seq_ptr += 1
                i += 1
            elif op == "D":
                dl = 0
                while i < n and cigar[i] == "D":
                    dl += 1
                    i += 1
                if ref_ptr > 0:
                    records.append(VcfRecord(
                        contig=contig, pos=ref_ptr - 1, id=".",
                        alleles=(ref[ref_ptr - 1:ref_ptr + dl],
                                 ref[ref_ptr - 1]),
                        qual=60, filter="PASS", info=".", fmt="GT",
                        sample="."))
                ref_ptr += dl
            elif op == "I":
                il = 0
                while i < n and cigar[i] == "I":
                    il += 1
                    i += 1
                if ref_ptr > 0 and seq_ptr > 0:
                    records.append(VcfRecord(
                        contig=contig, pos=ref_ptr - 1, id=".",
                        alleles=(ref[ref_ptr - 1],
                                 ref[ref_ptr - 1]
                                 + seq[seq_ptr:seq_ptr + il]),
                        qual=60, filter="PASS", info=".", fmt="GT",
                        sample="."))
                seq_ptr += il
            else:
                raise ValueError(f"unrecognized CIGAR operation '{op}'")
    return write_vcf(f"{out_pre}{hap}.vcf.gz", make_header(contigs), records)
