"""A seeded whole-genome BAM of the shape ``minimap2 -ax map-ont --eqx``,
``samtools sort`` and ``samtools calmd`` leave, and its FASTA: a frozen
copy of the port's ``testing/genome_reads.py`` with the parts of
``testing/long_reads.py`` (read lengths, noise) and ``testing/synth.py``
(``md_tag``) that it uses. The same
seed and layout give the same files byte for byte
(``benchmark/tests/test_bench_traffic.py``).

A layout with ``noise`` names a directory of confusion counts
(``subs_cm``, ``inss_cm``, ``dels_cm``, ``nps_cm``, as the realigner's
training writes them): each read's errors are then drawn from those counts
(``ConfusionNoise``), n-polymer length errors included, in place of the
port's uniform 3% / 5% / 3% model.

The layout is data: a workload file's ``traffic.layout`` names every
field of ``Layout``. Beside the FASTA and the BAM, ``write`` leaves
``expected.jsonl``: one line for each record the realign CLI is to emit
(primary, mapped, with MD, on a FASTA contig), in BAM order, with what the
harness's reference needs to work its line out again.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from .synth import bases as _bases, genome_with_runs, make_ref
from .writers import collapse_cigar, write_bam, write_fasta

PRIMARY, NO_MD, M_OPS = "primary", "no_md", "m_ops"
DECOY, SUPPLEMENTARY, SECONDARY, UNMAPPED = (
    "decoy", "supplementary", "secondary", "unmapped")

SIGMA = 0.6
P_SUB, P_INS, P_DEL = 0.03, 0.05, 0.03
_N, _X, _D = (ord(c) for c in "NXD")
_EQ, _I = ord("="), ord("I")
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_LUT = np.zeros(256, dtype=np.int64)        # N and others 0, ACGT 1-4
_LUT[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(1, 5)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class Layout:
    contigs: Tuple[Tuple[str, int], ...]   # with reads, in FASTA order
    unplaced: Tuple[str, int]              # in the FASTA, no reads
    decoy: Tuple[str, int]                 # in the header, not the FASTA
    lead_n: int                            # N bases that begin contigs[0]
    short_gap: Tuple[int, int]             # N gap lengths, reads span these
    long_gap: Tuple[int, int]              # ... and not these
    primary: int                           # primary reads on contigs
    median: float                          # read lengths: log-normal
    lengths: Tuple[int, int]               # ... clipped to these
    chrm_reads: int                        # of ``primary``, on the last
    n_spanning: int                        # of ``primary``, across a gap
    no_md: int
    m_ops: int
    decoy_reads: int
    supplementary: int
    secondary: int
    unmapped: int
    clip: Tuple[int, int] = (1, 2_000)     # soft clip lengths
    noise: str = ""                        # confusion counts; "": uniform

    @classmethod
    def from_json(cls, d: dict) -> "Layout":
        def tup(v):
            return tuple(tup(x) for x in v) if isinstance(v, list) else v
        return cls(**{k: tup(v) for k, v in d.items()})


@dataclasses.dataclass
class Read:
    kind: str
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    seq: str
    qual: str
    tags: Dict[str, Tuple[str, object]]
    ecigar: str = ""
    clips: Tuple[int, int] = (0, 0)
    hard_clips: Tuple[int, int] = (0, 0)
    spans_gap: bool = False

    @property
    def span(self) -> int:
        return len(self.ecigar) - self.ecigar.count("I")

    @property
    def cli_cigar(self) -> str:
        if self.kind == M_OPS:
            return self.ecigar.replace("=", "M").replace("X", "M")
        return self.ecigar


@dataclasses.dataclass
class Genome:
    fasta: Dict[str, str]
    header: List[Tuple[str, int]]
    gaps: Dict[str, List[Tuple[int, int]]]
    reads: List[Read]


# --- synth / long_reads ----------------------------------------------------

def md_tag(ref: str, pos: int, cigar: str) -> str:
    """MD tag of an extended '=XID' CIGAR (samtools calmd): the count of
    '=' before each X (then its reference base) and each run of D (then
    '^' and its bases), and the count after the last."""
    c = np.frombuffer(cigar.encode("ascii"), dtype=np.uint8)
    is_d = c == _D
    ev = np.flatnonzero((c == _X) | (is_d & ~np.concatenate(([False],
                                                             is_d[:-1]))))
    eq_before = np.concatenate(([0], np.cumsum(c == _EQ)))
    rp = pos + np.concatenate(([0], np.cumsum(c != _I)))[ev]
    matches = np.diff(np.concatenate(([0], eq_before[ev]))).tolist()
    ends = np.flatnonzero(np.diff(np.concatenate((is_d, [False])).astype(
        np.int8)) == -1)
    d_ev = is_d[ev]
    k = np.ones(len(ev), dtype=np.int64)
    k[d_ev] = ends[np.searchsorted(ends, ev[d_ev])] - ev[d_ev] + 1
    out = [f"{m}^{ref[p:p + n]}" if d else f"{m}{ref[p]}"
           for m, p, n, d in zip(matches, rp.tolist(), k.tolist(),
                                 d_ev.tolist())]
    out.append(str(int(eq_before[-1] - (eq_before[ev[-1]] if len(ev)
                                          else 0))))
    return "".join(out)


def read_lengths(rng, n: int, median: float, sigma: float,
                 lengths: Tuple[int, int]) -> np.ndarray:
    x = np.exp(rng.normal(np.log(median), sigma, n))
    return np.clip(np.rint(x), *lengths).astype(np.int64)


def noisy_copy(rng, ref: np.ndarray):
    """A read of ``ref`` with 3% deletions, 5% insertions (a random base
    before the base, which then takes a random substitute) and 3%
    substitutions: (seq, extended CIGAR) as uint8 ASCII arrays."""
    n = len(ref)
    u = rng.random(n)
    dele = u < P_DEL
    ins = (u >= P_DEL) & (u < P_DEL + P_INS)
    sub = (u >= P_DEL) & (u < P_DEL + P_INS + P_SUB)
    ins_base = _BASES[rng.integers(0, 4, n)]
    out = np.where(sub, _BASES[rng.integers(0, 4, n)], ref)
    c_end = np.cumsum(1 + ins)
    cig = np.empty(int(c_end[-1]) if n else 0, dtype=np.uint8)
    cig[c_end - 1] = np.where(dele, _D, np.where(out == ref, _EQ, _X))
    cig[c_end[ins] - 2] = _I
    s_end = np.cumsum(np.where(dele, 0, 1 + ins))
    seq = np.empty(int(s_end[-1]) if n else 0, dtype=np.uint8)
    seq[s_end[~dele] - 1] = out[~dele]
    seq[s_end[ins] - 2] = ins_base[ins]
    return seq, cig


class ConfusionNoise:
    """Read errors drawn from confusion counts, as the realigner's training
    counts them (``engine/stats.py``): at the start of each n-polymer run
    of 3 units or more (period 1-6, the shorter period first, the runs
    apart) the read's unit count from ``nps_cm[n - 1, units]``, the change
    written as whole units inserted or deleted at the run's start; before
    each base an insertion of random bases, and at each base a deletion,
    of lengths from ``inss_cm`` and ``dels_cm`` (the indels no run
    explains); each base kept called from its row of ``subs_cm``. The
    first and last base are kept, with no indel before the first."""

    def __init__(self, stats_dir: str, max_n: int = 6):
        def load(name):
            return np.load(os.path.join(stats_dir, f"{name}_cm.npy")
                           ).astype(np.float64)
        subs = load("subs")[:, 1:5]
        self.subs_cdf = np.cumsum(subs, 1) / subs.sum(1, keepdims=True)
        self.ins_cdf = np.cumsum(load("inss")) / load("inss").sum()
        self.del_cdf = np.cumsum(load("dels")) / load("dels").sum()
        nps = load("nps")
        tot = nps.sum(2, keepdims=True)
        self.nps_cdf = np.where(tot > 0, np.cumsum(nps, 2)
                                / np.maximum(tot, 1), 1.0)
        self.max_n = max_n
        self._runs: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    @staticmethod
    def find_runs(seq: np.ndarray, max_n: int):
        """(start, period, units) of the n-polymer runs of ``seq`` (uint8
        ASCII), 3 units or more, none overlapping another, by start."""
        covered = np.zeros(len(seq), bool)
        out = []
        for n in range(1, max_n + 1):
            if len(seq) <= n:
                break
            m = (seq[:-n] == seq[n:]) & (seq[:-n] != _N)
            d = np.diff(np.concatenate(([0], m.astype(np.int8), [0])))
            a, e = np.flatnonzero(d == 1), np.flatnonzero(d == -1)
            units = (e - a) // n + 1
            a, units = a[units >= 3], units[units >= 3]
            end = a + units * n
            cum = np.concatenate(([0], np.cumsum(covered)))
            free = cum[end] == cum[a]
            free[1:] &= a[1:] >= end[:-1]
            a, units, end = a[free], units[free], end[free]
            mark = np.zeros(len(seq) + 1, np.int64)
            np.add.at(mark, a, 1)
            np.add.at(mark, end, -1)
            covered |= np.cumsum(mark)[:-1] > 0
            out.append((a, np.full(len(a), n), units))
        a = np.concatenate([o[0] for o in out])
        o = np.argsort(a, kind="stable")
        return (a[o], np.concatenate([x[1] for x in out])[o],
                np.concatenate([x[2] for x in out])[o])

    def runs(self, name: str, contig: np.ndarray, pos: int, span: int):
        """The runs that lie inside [pos + 1, pos + span - 1), relative to
        ``pos``."""
        if name not in self._runs:
            self._runs[name] = self.find_runs(contig, self.max_n)
        a, n, u = self._runs[name]
        lo, hi = np.searchsorted(a, [pos + 1, pos + span - 1])
        a, n, u = a[lo:hi] - pos, n[lo:hi], u[lo:hi]
        inside = a + n * u <= span - 1
        return a[inside], n[inside], u[inside]

    def copy(self, rng, ref: np.ndarray, runs):
        """(seq, extended CIGAR) as uint8 ASCII arrays."""
        size = len(ref)
        a, per, units = runs
        l = np.minimum(units, self.nps_cdf.shape[1] - 1)
        got = (rng.random(len(a))[:, None] > self.nps_cdf[per - 1, l]).sum(1)
        delta = got - l
        ins_len = np.zeros(size, np.int64)
        ins_per = np.zeros(size, np.int64)
        dele = np.zeros(size + 1, np.int64)
        grow = delta > 0
        ins_len[a[grow]] = delta[grow] * per[grow]
        ins_per[a[grow]] = per[grow]
        cut = delta < 0
        np.add.at(dele, a[cut], 1)
        np.add.at(dele, a[cut] - delta[cut] * per[cut], -1)
        k_ins = np.searchsorted(self.ins_cdf, rng.random(size), "right")
        k_del = np.searchsorted(self.del_cdf, rng.random(size), "right")
        k_ins[0] = k_del[0] = k_del[-1] = 0
        plain = (k_ins > 0) & (ins_len == 0)
        ins_len[plain] = k_ins[plain]
        at = np.flatnonzero(k_del)
        np.add.at(dele, at, 1)
        np.add.at(dele, np.minimum(at + k_del[at], size - 1), -1)
        dele = np.cumsum(dele)[:size] > 0
        code = _LUT[ref]
        call = (rng.random(size)[:, None] > self.subs_cdf[code]).sum(1)
        out = _BASES[np.minimum(call, 3)]     # the last column at u ~ 1
        c_end = np.cumsum(1 + ins_len)
        cig = np.full(int(c_end[-1]), _I, dtype=np.uint8)
        cig[c_end - 1] = np.where(dele, _D, np.where(out == ref, _EQ, _X))
        s_end = np.cumsum(ins_len + ~dele)
        seq = np.empty(int(s_end[-1]), dtype=np.uint8)
        is_base = np.zeros(len(seq), bool)
        is_base[s_end[~dele] - 1] = True
        seq[is_base] = out[~dele]
        at = np.repeat(np.arange(size), ins_len)
        j = np.arange(len(at)) - np.repeat(np.cumsum(ins_len) - ins_len,
                                           ins_len)
        unit = np.repeat(ins_per, ins_len)
        seq[~is_base] = np.where(
            unit > 0, ref[np.minimum(at + j % np.maximum(unit, 1), size - 1)],
            _BASES[rng.integers(0, 4, len(at))])
        return seq, cig


# --- genome_reads ----------------------------------------------------------

def _uuid(rng) -> str:
    h = rng.bytes(16).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def _qual(rng, n: int) -> str:
    q = np.clip(np.rint(rng.normal(18, 6, n)), 2, 50).astype(np.uint8)
    return (q + 33).tobytes().decode("ascii")


def _contig(rng, n: int, layout: Layout, first: bool, last: bool):
    seq = np.frombuffer(genome_with_runs(rng, n)[0].encode(),
                        np.uint8).copy()
    gaps = []
    if first:
        gaps.append((0, layout.lead_n))
    elif not last:
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


def _copy(rng, ref: np.ndarray, noise=None, runs=None):
    seq, cig = noisy_copy(rng, ref) if noise is None else \
        noise.copy(rng, ref, runs)
    at_n = np.flatnonzero(seq == _N)
    if len(at_n):
        seq[at_n] = _BASES[rng.integers(0, 4, len(at_n))]
        cig[np.flatnonzero(cig != _D)[at_n]] = _X
    return seq.tobytes().decode("ascii"), cig.tobytes().decode("ascii")


def _place(rng, span: int, nmask_cum: np.ndarray, n: int) -> int:
    for _ in range(1000):
        p = int(rng.integers(0, n - span + 1))
        if nmask_cum[p + span] == nmask_cum[p]:
            return p
    raise ValueError(f"no N-free place for {span} bp in a contig of {n}")


def _nm(ecig: str) -> int:
    return len(ecig) - ecig.count("=")


def _aligned(rng, kind: str, contig: np.ndarray, pos: int, span: int,
             rname: str, noise=None) -> Read:
    runs = noise.runs(rname, contig, pos, span) if noise else None
    seq, ecig = _copy(rng, contig[pos:pos + span], noise, runs)
    ref = contig[pos:pos + span].tobytes().decode("ascii")
    tags = {"MD": ("Z", md_tag(ref, 0, ecig)), "NM": ("i", _nm(ecig))}
    return Read(kind=kind, qname=_uuid(rng), flag=0, rname=rname, pos=pos,
                mapq=60, cigar="", seq=seq, qual="", tags=tags, ecigar=ecig)


def _clip(rng, r: Read, clip: Tuple[int, int]) -> None:
    ends = int(rng.integers(0, 3))
    lead = int(rng.integers(clip[0], clip[1] + 1)) if ends != 1 else 0
    tail = int(rng.integers(clip[0], clip[1] + 1)) if ends != 0 else 0
    r.seq = _bases(rng, lead) + r.seq + _bases(rng, tail)
    r.clips = (lead, tail)


def _run_length(r: Read) -> str:
    (hl, ht), (sl, st) = r.hard_clips, r.clips
    return ((f"{hl}H" if hl else "") + (f"{sl}S" if sl else "")
            + collapse_cigar(r.cli_cigar)
            + (f"{st}S" if st else "") + (f"{ht}H" if ht else ""))


def _sa(r: Read) -> str:
    strand = "-" if r.flag & 16 else "+"
    cig = _run_length(r).replace("H", "S")
    return f"{r.rname},{r.pos + 1},{strand},{cig},{r.mapq},{_nm(r.ecigar)};"


def make(seed: int, layout: Layout) -> Genome:
    """The genome and the BAM's records, in BAM order."""
    rng = np.random.default_rng(seed)
    noise = ConfusionNoise(os.path.join(ROOT, layout.noise)) \
        if layout.noise else None
    names = [c for c, _ in layout.contigs]
    seqs, gaps, cums = {}, {}, {}
    for i, (name, n) in enumerate(layout.contigs):
        seqs[name], gaps[name] = _contig(rng, n, layout, i == 0,
                                         i == len(names) - 1)
        cums[name] = np.concatenate(([0], np.cumsum(seqs[name] == _N)))
    unplaced = np.frombuffer(genome_with_runs(
        rng, layout.unplaced[1])[0].encode(), np.uint8)
    decoy = np.frombuffer(make_ref(rng, layout.decoy[1]).encode(), np.uint8)
    spans = read_lengths(rng, layout.primary, layout.median, SIGMA,
                         layout.lengths)

    weights = np.array([n for _, n in layout.contigs[:-1]], np.float64)
    on = list(rng.choice(len(weights), layout.primary - layout.chrm_reads,
                         p=weights / weights.sum()))
    on += [len(names) - 1] * layout.chrm_reads
    short = [(c, gaps[names[c]][0]) for c in range(1, len(names) - 1)]
    reads: List[Read] = []
    placed = {"first": set(), "last": set()}
    spanning = 0
    for c, span in zip(on, spans.tolist()):
        name = names[int(c)]
        n = len(seqs[name])
        span = min(span, n - 1)
        if spanning < layout.n_spanning:
            c, (gs, ge) = short[spanning % len(short)]
            name = names[c]
            span = max(span, ge - gs + 600)
            pos = gs - int(rng.integers(200, span - (ge - gs) - 200))
            spanning += 1
            r = _aligned(rng, PRIMARY, seqs[name], pos, span, name, noise)
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
        reads.append(_aligned(rng, PRIMARY, seqs[name], pos, span, name,
                              noise))

    plain = [i for i, r in enumerate(reads) if not r.spans_gap
             and 0 < r.pos and r.pos + r.span < len(seqs[r.rname])]
    pick = rng.choice(plain, layout.no_md + layout.m_ops, replace=False)
    for i in pick[:layout.no_md]:
        reads[i].kind = NO_MD
        del reads[i].tags["MD"]
    for i in pick[layout.no_md:]:
        reads[i].kind = M_OPS
    for _ in range(layout.decoy_reads):
        span = min(int(read_lengths(rng, 1, layout.median, SIGMA,
                                    layout.lengths)[0]), len(decoy) - 1)
        pos = int(rng.integers(0, len(decoy) - span + 1))
        reads.append(_aligned(rng, DECOY, decoy, pos, span,
                              layout.decoy[0], noise))

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
                        _place(rng, span, cums[name], n), span, name, noise)

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

    header = list(layout.contigs) + [layout.unplaced, layout.decoy]
    rid = {name: i for i, (name, _) in enumerate(header)}
    reads.sort(key=lambda r: (rid[r.rname], r.pos))
    for _ in range(layout.unmapped):
        seq = _bases(rng, int(rng.integers(500, 5_000)))
        reads.append(Read(kind=UNMAPPED, qname=_uuid(rng), flag=4,
                          rname="*", pos=-1, mapq=0, cigar="*", seq=seq,
                          qual=_qual(rng, len(seq)), tags={}))
    fasta = {name: seqs[name].tobytes().decode("ascii") for name in names}
    fasta[layout.unplaced[0]] = unplaced.tobytes().decode("ascii")
    return Genome(fasta=fasta, header=header, gaps=gaps, reads=reads)


def expected(genome: Genome) -> List[Read]:
    """The records the realign CLI writes a line for: primary, mapped,
    with an MD tag, on a contig of the FASTA; in BAM order."""
    return [r for r in genome.reads if r.kind in (PRIMARY, M_OPS)
            and r.rname in genome.fasta]


def write(d: str, genome: Genome) -> Dict[str, str]:
    """``{d}/genome.fasta``, ``{d}/genome.bam`` (minimap2's and samtools'
    header lines) and ``{d}/expected.jsonl``; their paths by role."""
    os.makedirs(d, exist_ok=True)
    text = "\n".join(
        ["@HD\tVN:1.6\tSO:coordinate"]
        + [f"@SQ\tSN:{n}\tLN:{ln}" for n, ln in genome.header]
        + ["@PG\tID:minimap2\tPN:minimap2\tVN:2.26-r1175\tCL:minimap2 -ax "
           "map-ont --eqx ref.fa reads.fastq",
           "@PG\tID:samtools\tPN:samtools\tPP:minimap2\tVN:1.17\tCL:"
           "samtools calmd -b genome.sorted.bam ref.fa"]) + "\n"
    paths = {"fasta": os.path.join(d, "genome.fasta"),
             "bam": os.path.join(d, "genome.bam"),
             "expected": os.path.join(d, "expected.jsonl")}
    write_fasta(paths["fasta"], genome.fasta)
    write_bam(paths["bam"], [n for n, _ in genome.header],
              [ln for _, ln in genome.header],
              ((r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar, r.seq,
                r.qual, r.tags) for r in genome.reads), header_text=text)
    with open(paths["expected"], "w") as fh:
        for r in expected(genome):
            lead, tail = r.clips
            fh.write(json.dumps({
                "qname": r.qname, "flag": r.flag, "rname": r.rname,
                "pos": r.pos, "mapq": r.mapq, "cigar": r.cli_cigar,
                "seq": r.seq[lead:len(r.seq) - tail],
                "qual": r.qual[lead:len(r.qual) - tail],
                "hp": int(r.tags["HP"][1]) if "HP" in r.tags else 0}) + "\n")
    return paths
