"""A seeded whole-genome BAM of the shape ``minimap2 -ax map-ont --eqx``,
``samtools sort`` and ``samtools calmd`` leave (``scripts/align.sh``), and
its FASTA, made with numpy.

The genome: chromosomes of ``synth.genome_with_runs``' repeat density
(``chr1``-``chr8`` of 6 to 0.5 Mbp and ``chrM``, 23 Mbp in all); ``chr1``
begins with 10,000 N as hg38's does, and each later chromosome but ``chrM``
holds a short N gap (100-300 bp), every other one also a long one
(1,000-10,000 bp). ``chrUn_1`` is in the FASTA and the BAM header and has
no reads; ``decoy_1`` is in the header, with reads, and not in the FASTA.

The records, in the order a coordinate sort leaves them:
- primary reads with ``long_reads``' lengths (median 10 kb, sigma 0.6,
  1-60 kb) and noise, half of them on the reverse strand (flag 16), 70%
  with a soft clip of 1-2,000 random bases at one end or both, QUAL drawn
  per base, MAPQ 0 on 10% (60 on the rest), an HP tag on 60%; on each
  chromosome one starts at its first base (where that is not N) and one
  ends at its last; at least ``n_spanning`` span a short N gap, where the
  read holds random bases, the CIGAR an X and the MD tag the N; of the
  others, ``no_md`` have no MD tag and ``m_ops`` write ``M`` in place of
  ``=``/``X`` (minimap2 without ``--eqx``); the rest avoid N;
- supplementary records (flag 2048 or 2064) of other loci, with hard clips
  and an ``SA`` tag, each of a primary read's name (the primary carries the
  matching ``SA``);
- secondary records (flag 256 or 272) with SEQ and QUAL ``*``, soft clips
  and an MD tag (``minimap2 --MD`` writes one on every aligned record);
- ``decoy_reads`` primary reads on ``decoy_1``;
- unmapped records (flag 4, RNAME ``*``) at the end of the file.

``FULL`` is the card's input (2,000 primary reads, about 25 Mb);
``REDUCED`` keeps every kind of record, a few of each, on 4 chromosomes of
60-150 kb and ``chrM`` for the CPU::

    python -c "from npore_tpu_torch.testing import genome_reads as gr; \\
        print(gr.write_genome_reads('/tmp/gr', gr.make_genome_reads( \\
            layout=gr.REDUCED)))"

then ``python -m npore_tpu_torch.cli.realign --bam /tmp/gr/genome.bam
--ref /tmp/gr/genome.fasta --out_prefix /tmp/gr/out --stats_dir
guppy5_stats --engine torch``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from . import long_reads, synth

SEED = 29
PRIMARY, NO_MD, M_OPS = "primary", "no_md", "m_ops"
DECOY, SUPPLEMENTARY, SECONDARY, UNMAPPED = (
    "decoy", "supplementary", "secondary", "unmapped")
KINDS = (PRIMARY, NO_MD, M_OPS, DECOY, SUPPLEMENTARY, SECONDARY, UNMAPPED)

_N, _X, _D = (ord(c) for c in "NXD")
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass(frozen=True)
class Layout:
    contigs: Tuple[Tuple[str, int], ...]   # with reads, in FASTA order
    unplaced: Tuple[str, int]              # in the FASTA, no reads
    decoy: Tuple[str, int]                 # in the header, not the FASTA
    lead_n: int                            # N bases that begin contigs[0]
    short_gap: Tuple[int, int]             # N gap lengths, reads span these
    long_gap: Tuple[int, int]              # ... and not these
    primary: int                           # primary reads on contigs
    median: float                          # read lengths (long_reads')
    lengths: Tuple[int, int]
    chrm_reads: int                        # of ``primary``, on the last
    n_spanning: int                        # of ``primary``, across a gap
    no_md: int
    m_ops: int
    decoy_reads: int
    supplementary: int
    secondary: int
    unmapped: int
    clip: Tuple[int, int] = (1, 2_000)     # soft clip lengths


FULL = Layout(
    contigs=(("chr1", 6_000_000), ("chr2", 5_000_000), ("chr3", 4_000_000),
             ("chr4", 3_000_000), ("chr5", 2_000_000), ("chr6", 1_500_000),
             ("chr7", 1_000_000), ("chr8", 500_000), ("chrM", 16_569)),
    unplaced=("chrUn_1", 40_000), decoy=("decoy_1", 100_000),
    lead_n=10_000, short_gap=(100, 300), long_gap=(1_000, 10_000),
    primary=2_000, median=long_reads.MEDIAN, lengths=long_reads.LENGTHS,
    chrm_reads=20, n_spanning=21, no_md=10, m_ops=20, decoy_reads=5,
    supplementary=100, secondary=60, unmapped=40)

REDUCED = dataclasses.replace(
    FULL, contigs=(("chr1", 150_000), ("chr2", 120_000), ("chr3", 90_000),
                   ("chr4", 60_000), ("chrM", 16_569)),
    unplaced=("chrUn_1", 20_000), decoy=("decoy_1", 20_000), lead_n=10_000,
    long_gap=(1_000, 3_000), primary=40, median=1_500, lengths=(1_000, 2_000),
    chrm_reads=3, n_spanning=12, no_md=2, m_ops=3, decoy_reads=2,
    supplementary=4, secondary=4, unmapped=3, clip=(1, 300))


@dataclasses.dataclass
class Read:
    """One BAM record and what it was made from."""
    kind: str
    qname: str
    flag: int
    rname: str
    pos: int                 # 0-based; -1 unmapped
    mapq: int
    cigar: str               # run-length, with clips
    seq: str                 # the whole read ('*' for a secondary)
    qual: str
    tags: Dict[str, Tuple[str, object]]
    ecigar: str = ""         # extended '=XID' CIGAR of the aligned part
    clips: Tuple[int, int] = (0, 0)          # soft clips (lead, tail)
    hard_clips: Tuple[int, int] = (0, 0)     # hard clips (lead, tail)
    spans_gap: bool = False

    @property
    def aligned_seq(self) -> str:
        return self.seq[self.clips[0]:len(self.seq) - self.clips[1]]

    @property
    def aligned_qual(self) -> str:
        return self.qual[self.clips[0]:len(self.qual) - self.clips[1]]

    @property
    def span(self) -> int:
        """Reference bases the alignment covers."""
        return len(self.ecigar) - self.ecigar.count("I")

    @property
    def cli_cigar(self) -> str:
        """The extended CIGAR the realign CLI decodes from the record:
        ``M`` in place of ``=`` and ``X`` for an ``m_ops`` read."""
        if self.kind == M_OPS:
            return self.ecigar.replace("=", "M").replace("X", "M")
        return self.ecigar


@dataclasses.dataclass
class Genome:
    fasta: Dict[str, str]                    # FASTA contigs, in order
    header: List[Tuple[str, int]]            # BAM @SQ names and lengths
    gaps: Dict[str, List[Tuple[int, int]]]   # N intervals [start, end)
    reads: List[Read]                        # in BAM order


def _uuid(rng) -> str:
    h = rng.bytes(16).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def _qual(rng, n: int) -> str:
    """Per-base phred+33 qualities, nanopore-like: mostly 10-30."""
    q = np.clip(np.rint(rng.normal(18, 6, n)), 2, 50).astype(np.uint8)
    return (q + 33).tobytes().decode("ascii")


def _random_bases(rng, n: int) -> str:
    return _BASES[rng.integers(0, 4, n)].tobytes().decode("ascii")


def _contig(rng, name: str, n: int, layout: Layout, first: bool,
            last: bool):
    """A chromosome of ``genome_with_runs``' density with its N gaps."""
    seq = np.frombuffer(synth.genome_with_runs(rng, n)[0].encode(),
                        np.uint8).copy()
    gaps = []
    if first:
        gaps.append((0, layout.lead_n))
    elif not last:
        # a short gap in the first third, and on about every other contig
        # a long one in the second half: a read that spans the short gap
        # (its start past n // 8 - 60 kb) stays clear of the long one
        g = int(rng.integers(layout.short_gap[0], layout.short_gap[1] + 1))
        s = int(rng.integers(n // 8, n // 3 - g))
        gaps.append((s, s + g))
        if rng.random() < 0.5:
            g = int(rng.integers(layout.long_gap[0], layout.long_gap[1] + 1))
            s = int(rng.integers(n // 2, n - n // 8 - g))
            gaps.append((s, s + g))
    for s, e in gaps:
        seq[s:e] = _N
    return seq, gaps


def _copy(rng, ref: np.ndarray):
    """``long_reads.noisy_copy`` of ``ref``; where ``ref`` holds N the
    read holds a random base and the CIGAR an X, as minimap2 aligns a read
    across an assembly gap. (seq, extended CIGAR) as str."""
    seq, cig = long_reads.noisy_copy(rng, ref)
    at_n = np.flatnonzero(seq == _N)
    if len(at_n):
        seq[at_n] = _BASES[rng.integers(0, 4, len(at_n))]
        cig[np.flatnonzero(cig != _D)[at_n]] = _X
    return seq.tobytes().decode("ascii"), cig.tobytes().decode("ascii")


def _place(rng, span: int, nmask_cum: np.ndarray, n: int) -> int:
    """A position for a read of ``span`` that covers no N."""
    for _ in range(1000):
        p = int(rng.integers(0, n - span + 1))
        if nmask_cum[p + span] == nmask_cum[p]:
            return p
    raise ValueError(f"no N-free place for {span} bp in a contig of {n}")


def _nm(ecig: str) -> int:
    return len(ecig) - ecig.count("=")


def _aligned(rng, kind: str, contig: np.ndarray, pos: int, span: int,
             rname: str) -> Read:
    """A read copied from ``contig[pos:pos + span]``, unclipped."""
    seq, ecig = _copy(rng, contig[pos:pos + span])
    ref = contig[pos:pos + span].tobytes().decode("ascii")
    tags = {"MD": ("Z", synth.md_tag(ref, 0, ecig)), "NM": ("i", _nm(ecig))}
    return Read(kind=kind, qname=_uuid(rng), flag=0, rname=rname, pos=pos,
                mapq=60, cigar="", seq=seq, qual="", tags=tags, ecigar=ecig)


def _clip(rng, r: Read, clip: Tuple[int, int]) -> None:
    """Soft clips of random bases at one end or both."""
    ends = int(rng.integers(0, 3))          # 0 lead, 1 tail, 2 both
    lead = int(rng.integers(clip[0], clip[1] + 1)) if ends != 1 else 0
    tail = int(rng.integers(clip[0], clip[1] + 1)) if ends != 0 else 0
    r.seq = _random_bases(rng, lead) + r.seq + _random_bases(rng, tail)
    r.clips = (lead, tail)


def _run_length(r: Read) -> str:
    from ..io.cigar import collapse_cigar
    (hl, ht), (sl, st) = r.hard_clips, r.clips
    return ((f"{hl}H" if hl else "") + (f"{sl}S" if sl else "")
            + collapse_cigar(r.cli_cigar)
            + (f"{st}S" if st else "") + (f"{ht}H" if ht else ""))


def _sa(r: Read) -> str:
    strand = "-" if r.flag & 16 else "+"
    cig = _run_length(r).replace("H", "S")
    return f"{r.rname},{r.pos + 1},{strand},{cig},{r.mapq},{_nm(r.ecigar)};"


def make_genome_reads(seed: int = SEED, layout: Layout = FULL) -> Genome:
    """The genome and the BAM's records (see the module docstring)."""
    rng = np.random.default_rng(seed)
    names = [c for c, _ in layout.contigs]
    seqs, gaps, cums = {}, {}, {}
    for i, (name, n) in enumerate(layout.contigs):
        seqs[name], gaps[name] = _contig(rng, name, n, layout, i == 0,
                                         i == len(names) - 1)
        cums[name] = np.concatenate(([0], np.cumsum(seqs[name] == _N)))
    unplaced = np.frombuffer(synth.genome_with_runs(
        rng, layout.unplaced[1])[0].encode(), np.uint8)
    decoy = np.frombuffer(synth.make_ref(rng, layout.decoy[1]).encode(),
                          np.uint8)
    chrm = names[-1]
    spans = long_reads.read_lengths(rng, layout.primary, layout.median,
                                    long_reads.SIGMA, layout.lengths)

    # which contig each primary read is on: chrm_reads on chrM, the rest
    # by length; on each contig one at its first base (not N) and one at
    # its last; n_spanning across the short gaps, in turns
    weights = np.array([n for _, n in layout.contigs[:-1]], np.float64)
    on = list(rng.choice(len(weights), layout.primary - layout.chrm_reads,
                         p=weights / weights.sum()))
    on += [len(names) - 1] * layout.chrm_reads
    short = [(c, gaps[names[c]][0]) for c in range(1, len(names) - 1)]
    reads: List[Read] = []
    placed = {"first": set(), "last": set()}
    spanning = 0
    for k, (c, span) in enumerate(zip(on, spans.tolist())):
        name = names[int(c)]
        n = len(seqs[name])
        span = min(span, n - 1)
        if spanning < layout.n_spanning:
            c, (gs, ge) = short[spanning % len(short)]
            name = names[c]
            span = max(span, ge - gs + 600)
            pos = gs - int(rng.integers(200, span - (ge - gs) - 200))
            spanning += 1
            r = _aligned(rng, PRIMARY, seqs[name], pos, span, name)
            r.spans_gap = True
            reads.append(r)
            continue
        cum = cums[name]
        if name not in placed["first"] and cum[1] == 0:
            pos = 0 if cum[span] == 0 else _place(rng, span, cum, n)
            placed["first"].add(name)
        elif name not in placed["last"]:
            pos = n - span if cum[n] == cum[n - span] else \
                _place(rng, span, cum, n)
            placed["last"].add(name)
        else:
            pos = _place(rng, span, cum, n)
        reads.append(_aligned(rng, PRIMARY, seqs[name], pos, span, name))

    # the kinds of the primary reads that are neither at an end nor across
    # a gap: no MD, M ops
    plain = [i for i, r in enumerate(reads) if not r.spans_gap
             and 0 < r.pos and r.pos + r.span < len(seqs[r.rname])]
    pick = rng.choice(plain, layout.no_md + layout.m_ops, replace=False)
    for i in pick[:layout.no_md]:
        reads[i].kind = NO_MD
        del reads[i].tags["MD"]
    for i in pick[layout.no_md:]:
        reads[i].kind = M_OPS
    for _ in range(layout.decoy_reads):
        span = min(int(long_reads.read_lengths(
            rng, 1, layout.median, long_reads.SIGMA, layout.lengths)[0]),
            len(decoy) - 1)
        pos = int(rng.integers(0, len(decoy) - span + 1))
        reads.append(_aligned(rng, DECOY, decoy, pos, span,
                              layout.decoy[0]))

    n_primary = len(reads)
    rev = rng.random(n_primary) < 0.5
    clipped = rng.random(n_primary) < 0.7
    mapq0 = rng.random(n_primary) < 0.1
    hp = np.where(rng.random(n_primary) < 0.6,
                  rng.integers(1, 3, n_primary), 0)
    for r, rv, cl, m0, h in zip(reads, rev, clipped, mapq0, hp.tolist()):
        r.flag = 16 if rv else 0
        r.mapq = 0 if m0 else 60
        if cl:
            _clip(rng, r, layout.clip)
        r.qual = _qual(rng, len(r.seq))
        if h:
            r.tags["HP"] = ("i", h)

    def other_locus(kind: str, lo: int, hi: int) -> Read:
        c = int(rng.choice(len(weights), p=weights / weights.sum()))
        name = names[c]
        n = len(seqs[name])
        span = int(rng.integers(lo, hi + 1))
        return _aligned(rng, kind, seqs[name],
                        _place(rng, span, cums[name], n), span, name)

    # supplementary: another locus of a primary read, hard-clipped
    for i in rng.choice(n_primary, layout.supplementary, replace=False):
        p = reads[i]
        s = other_locus(SUPPLEMENTARY, 500, 5_000)
        s.qname = p.qname
        s.flag = 2048 | (16 if rng.random() < 0.5 else 0)
        s.mapq = int(rng.integers(1, 61))
        s.hard_clips = (int(rng.integers(1, 2_000)),
                        int(rng.integers(0, 2_000)))
        s.qual = _qual(rng, len(s.seq))
        s.cigar = _run_length(s)
        s.tags["SA"] = ("Z", _sa(p))
        p.tags["SA"] = ("Z", _sa(s))
        reads.append(s)
    # secondary: another locus of a primary read, no SEQ or QUAL
    for i in rng.choice(n_primary, layout.secondary, replace=False):
        s = other_locus(SECONDARY, 500, 5_000)
        s.qname = reads[i].qname
        s.flag = 256 | (16 if rng.random() < 0.5 else 0)
        s.mapq = 0
        s.clips = (int(rng.integers(0, 2_000)), int(rng.integers(0, 2_000)))
        s.cigar = _run_length(s)
        s.seq = s.qual = "*"
        reads.append(s)
    for r in reads[:n_primary]:
        r.cigar = _run_length(r)

    # a coordinate sort: mapped records by (header order, position), the
    # unmapped at the end
    header = list(layout.contigs) + [layout.unplaced, layout.decoy]
    rid = {name: i for i, (name, _) in enumerate(header)}
    reads.sort(key=lambda r: (rid[r.rname], r.pos))
    for _ in range(layout.unmapped):
        seq = _random_bases(rng, int(rng.integers(500, 5_000)))
        reads.append(Read(kind=UNMAPPED, qname=_uuid(rng), flag=4,
                          rname="*", pos=-1, mapq=0, cigar="*", seq=seq,
                          qual=_qual(rng, len(seq)), tags={}))
    fasta = {name: seqs[name].tobytes().decode("ascii") for name in names}
    fasta[layout.unplaced[0]] = unplaced.tobytes().decode("ascii")
    return Genome(fasta=fasta, header=header, gaps=gaps, reads=reads)


def write_genome_reads(d: str, genome: Genome) -> Tuple[str, str]:
    """``genome`` as ``{d}/genome.fasta`` and a coordinate-sorted
    ``{d}/genome.bam`` with minimap2's and samtools' header lines (through
    ``io.bam_writer.write_bam``); the paths."""
    from ..io.bam_writer import write_bam
    from ..io.fasta import write_fasta
    from ..io.sam import SamRecord
    os.makedirs(d, exist_ok=True)
    names = [n for n, _ in genome.header]
    lengths = [ln for _, ln in genome.header]
    text = "\n".join(
        ["@HD\tVN:1.6\tSO:coordinate"]
        + [f"@SQ\tSN:{n}\tLN:{ln}" for n, ln in genome.header]
        + ["@PG\tID:minimap2\tPN:minimap2\tVN:2.26-r1175\tCL:minimap2 -ax "
           "map-ont --eqx ref.fa reads.fastq",
           "@PG\tID:samtools\tPN:samtools\tPP:minimap2\tVN:1.17\tCL:"
           "samtools calmd -b genome.sorted.bam ref.fa"]) + "\n"
    fasta = os.path.join(d, "genome.fasta")
    bam = os.path.join(d, "genome.bam")
    write_fasta(fasta, genome.fasta)
    write_bam(bam, names, lengths, (SamRecord(
        qname=r.qname, flag=r.flag, rname=r.rname, pos=r.pos, mapq=r.mapq,
        cigar=r.cigar, seq=r.seq, qual=r.qual, tags=r.tags)
        for r in genome.reads), header_text=text)
    return fasta, bam


def expected_output(genome: Genome) -> List[Read]:
    """The records the realign CLI writes a line for: primary, mapped,
    with an MD tag, on a contig of the FASTA; in BAM order."""
    return [r for r in genome.reads if r.kind in (PRIMARY, M_OPS)
            and r.rname in genome.fasta]


def counts(genome: Genome) -> Dict[str, int]:
    """Records of each kind."""
    out = {k: 0 for k in KINDS}
    for r in genome.reads:
        out[r.kind] += 1
    return out
