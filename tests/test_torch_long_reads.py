"""Reads at nanopore lengths (npore_tpu_torch/testing/long_reads.py): the
generator, its BAM, and multi-window reads through the port's engine held
to the JAX package's Pallas engine (interpret mode) and to the C++ golden
aligner."""
import re

import numpy as np
import pytest
import torch

from npore_tpu.config import AlignConfig as JaxAlignConfig
from npore_tpu.engine.pallas_engine import PallasEngine
from npore_tpu.engine.realigner import AlignItem as JaxAlignItem
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.engine import cuda_engine
from npore_tpu_torch.engine.realigner import AlignItem, Realigner
from npore_tpu_torch.engine.windows import build_windows
from npore_tpu_torch.io.bam import BamReader
from npore_tpu_torch.io.bam_native import NativeBamReader
from npore_tpu_torch.io.cigar import collapse_cigar, finalize_cigar
from npore_tpu_torch.native import golden_align_native
from npore_tpu_torch.testing import chunks, long_reads as lr, synth

torch.set_num_threads(2)

SEED = 23
# the slice against the JAX package: reads scaled to 1.2-2.0 kb, cut in
# windows of 500 rows, so that each makes 5-8 windows
SMALL = dict(median=1_600, lengths=(1_200, 2_000))
WINDOW_ROWS = 500


def _span(cigar: str) -> int:
    return sum(c != "I" for c in cigar)


def _items(contig, reads):
    return [AlignItem(bases_to_int(contig[p:p + _span(c)]), bases_to_int(s),
                      c) for p, s, c in reads]


@pytest.fixture(scope="module")
def full():
    """40 reads at the [long reads] phase's length distribution on a 1 Mbp
    contig."""
    return lr.make_long_reads(SEED, 40, 1_000_000)


def test_generator_is_seeded(full):
    contig, runs, reads = full
    again = lr.make_long_reads(SEED, 40, 1_000_000)
    assert again[0] == contig and np.array_equal(again[1], runs)
    assert again[2] == reads
    assert lr.make_long_reads(SEED + 1, 40, 1_000_000)[2] != reads
    assert [p for p, _, _ in reads] == sorted(p for p, _, _ in reads)


def test_lengths_in_bounds_and_median():
    x = lr.read_lengths(np.random.default_rng(SEED), 400)
    lo, hi = lr.LENGTHS
    assert x.min() >= lo and x.max() <= hi
    assert abs(np.median(x) - lr.MEDIAN) <= 0.15 * lr.MEDIAN


def test_cigars_consume_seq_and_span(full):
    """Each extended CIGAR consumes its read and the span drawn for it,
    and its '=' and 'X' say whether the read's base is the contig's."""
    contig, _, reads = full
    rng = np.random.default_rng(SEED)
    synth.genome_with_runs(rng, len(contig))
    spans = lr.read_lengths(rng, len(reads))
    assert sorted(_span(c) for _, _, c in reads) == sorted(spans.tolist())
    for pos, seq, cig in reads:
        c = np.frombuffer(cig.encode(), np.uint8)
        assert len(seq) == int((c != ord("D")).sum())
        q = np.frombuffer(seq.encode(), np.uint8)[c[c != ord("D")] != ord("I")]
        on_ref = c[c != ord("I")]
        r = np.frombuffer(contig[pos:pos + len(on_ref)].encode(), np.uint8)
        kept = on_ref != ord("D")
        assert np.array_equal(q == r[kept], on_ref[kept] == ord("="))


def test_noise_rates():
    """make_read's default rates on 2 Mb: 3% deletions, 5% insertions, and
    a random substitute (a mismatch 3 times in 4) for 8% of the bases: the
    3% substitutions and the base after each insertion. Bounds: 6 binomial
    standard deviations."""
    rng = np.random.default_rng(SEED)
    n = 2_000_000
    ref = np.frombuffer(synth.make_ref(rng, n).encode(), np.uint8)
    seq, cig = lr.noisy_copy(rng, ref)
    for op, p in (("D", lr.P_DEL), ("I", lr.P_INS),
                  ("X", (lr.P_INS + lr.P_SUB) * 0.75)):
        got = int((cig == ord(op)).sum())
        assert abs(got - p * n) <= 6 * np.sqrt(n * p * (1 - p)), op


def test_runs_in_the_contig(full):
    contig, runs, _ = full
    n = len(contig)
    assert n / 250 < len(runs) < n / 100
    assert set(runs[:, 1]) == set(range(1, 7))
    assert runs[:, 2].min() >= 3 and runs[:, 2].max() <= 20
    for s, p, k in runs[runs[:, 0] + runs[:, 1] * runs[:, 2] <= n].tolist():
        assert contig[s:s + p * k] == contig[s:s + p] * k


@pytest.fixture(scope="module")
def written(full, tmp_path_factory):
    """``full`` written by ``write_long_reads``: (FASTA, BAM)."""
    contig, _, reads = full
    return lr.write_long_reads(str(tmp_path_factory.mktemp("long")), contig,
                               reads, seed=SEED)


@pytest.mark.parametrize("pool", [NativeBamReader.POOL, 2 << 20])
def test_writer_reads_back(full, written, monkeypatch, pool):
    """The BAM reads back through the port's NativeBamReader as written,
    with the realignment inputs of each read; also with a decode pool
    (``POOL``) that fills after a few long records, so batches end early
    and resume."""
    contig, _, reads = full
    fasta, bam = written
    monkeypatch.setattr(NativeBamReader, "POOL", pool)
    got = list(NativeBamReader(bam))
    assert len(got) == len(reads)
    hp = np.random.default_rng(SEED).integers(0, 3, len(reads))
    for i, (rec, (pos, seq, cig)) in enumerate(zip(got, reads)):
        assert (rec.qname, rec.rname, rec.pos, rec.cigar, rec.seq) == (
            f"lr{i}", "ctg", pos, collapse_cigar(cig), seq)
        assert rec.tags == {"HP": ("i", int(hp[i])),
                            "MD": ("Z", synth.md_tag(contig, pos, cig))}
        ref, q, c = rec.aln
        assert c == cig
        assert np.array_equal(q, bases_to_int(seq))
        assert np.array_equal(ref, bases_to_int(contig[pos:pos + _span(cig)]))
    py = list(BamReader(bam))
    assert [(r.qname, r.pos, r.cigar, r.seq, r.tags) for r in py] == \
        [(r.qname, r.pos, r.cigar, r.seq, r.tags) for r in got]
    with open(fasta) as fh:
        assert fh.readline().strip() == ">ctg"


def _ref_from_md(md: str, seq: str, cigar: str) -> str:
    """The reference bases a read covers, rebuilt from its MD tag, its
    bases and its extended CIGAR: an '=' takes the read's base, an 'X'
    or a 'D' the base the MD tag names."""
    named = []                  # None where MD counts a match
    for n, deleted, base in re.findall(r"(\d+)|\^([A-Z]+)|([A-Z])", md):
        named += [None] * int(n) if n else list(deleted or base)
    out, q = [], 0
    for op in cigar:
        if op == "I":
            q += 1
            continue
        b = named[len(out)]
        if op == "=":
            assert b is None
            b = seq[q]
        else:
            assert b is not None and (op == "D" or b != seq[q])
        q += op != "D"
        out.append(b)
    assert len(out) == len(named) and q == len(seq)
    return "".join(out)


def test_md_tags_agree_with_the_contig(full, written):
    """The MD tags in the BAM, with each read's bases and CIGAR, give
    back the contig under the read."""
    contig, _, reads = full
    for rec, (pos, seq, cig) in zip(NativeBamReader(written[1]), reads):
        assert _ref_from_md(rec.tags["MD"][1], seq, cig) == \
            contig[pos:pos + _span(cig)]
    assert _ref_from_md(synth.md_tag("ACGT", 0, "DI=X"), "TCA", "DI=X") \
        == "ACG"


@pytest.fixture(scope="module")
def small():
    contig, _, reads = lr.make_long_reads(SEED, 4, 60_000, **SMALL)
    return _items(contig, reads)


def test_slice_matches_pallas_and_golden(score_matrices, small):
    """Multi-window reads: the port's Realigner(engine="torch") gives the
    CIGARs of the JAX package's PallasEngine (interpret mode) and of the
    port's C++ golden aligner, exactly. The Pallas engine's trimmed
    interpret-mode k-ladder bails on some windows of these repeat-dense
    reads and realigns those reads with its golden fallback; each window
    its kernels finished equals the port's window."""
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig(max_b_rows=WINDOW_ROWS)
    n_windows = [len(build_windows(it.ref, it.seq, it.cigar, cfg))
                 for it in small]
    assert min(n_windows) >= 5 and max(n_windows) <= 8
    eng = Realigner(sub_scores, np_scores, cfg, engine="torch")
    got = eng.align_batch(small)
    assert eng.bail_count == 0
    assert got == [golden_align_native(it.ref, it.seq, it.cigar, sub_scores,
                                       np_scores, cfg) for it in small]

    finished = []

    class Recording(PallasEngine):
        def _collect_group(self, group, res):
            out = super()._collect_group(group, res)
            finished.extend((w.key, c) for w, (c, bail) in zip(group, out)
                            if not bail)
            return out
    pallas = Recording(sub_scores, np_scores,
                       JaxAlignConfig(max_b_rows=WINDOW_ROWS),
                       interpret=True, g_call=1)
    assert pallas.align_batch([JaxAlignItem(it.ref, it.seq, it.cigar)
                               for it in small]) == got
    assert finished
    for (i, ci), cig in finished:
        inss, dels, breaks = chunks.breaks_of(small[i].cigar, cfg)
        b, e = breaks[ci], breaks[ci + 1]
        assert cig == chunks.chunk_of(got[i], int(inss[b]), int(dels[b]),
                                      int(inss[e]), int(dels[e]))


def test_whole_read_fallback_on_a_multi_window_read(score_matrices, small,
                                                    monkeypatch):
    """A bail in one window of a multi-window read sends the whole read to
    the golden aligner; the windows of the other reads are stitched as
    before."""
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig(max_b_rows=WINDOW_ROWS)
    decode = cuda_engine.decode

    def bail_once(meta, cig, ends):
        cigs, bails = decode(meta, cig, ends)
        bails = list(bails)
        bails[1] = True
        return ["X" * len(cigs[1]) if j == 1 else c
                for j, c in enumerate(cigs)], bails
    monkeypatch.setattr(cuda_engine, "decode", bail_once)
    eng = Realigner(sub_scores, np_scores, cfg, engine="torch")
    got = eng.align_batch(small)
    assert eng.bail_count == 1
    assert got == [golden_align_native(it.ref, it.seq, it.cigar, sub_scores,
                                       np_scores, cfg) for it in small]


def test_reduced_cli_run(score_matrices, tmp_path, stats_dir):
    """The realign CLI with --engine torch on a BAM of the generator's
    reads at 1-2 kb: every record written, and each CIGAR the golden
    aligner's, finalized, as chip_smoke.py's [long reads] checks."""
    from npore_tpu_torch.cli.realign import main
    sub_scores, np_scores, _, _ = score_matrices
    contig, _, reads = lr.make_long_reads(SEED, 4, 100_000, median=1_500,
                                          lengths=(1_000, 2_000))
    fasta, bam = lr.write_long_reads(str(tmp_path), contig, reads, seed=SEED)
    pre = str(tmp_path / "out")
    assert main(["--bam", bam, "--ref", fasta, "--out_prefix", pre,
                 "--stats_dir", stats_dir, "--engine", "torch"]) == 0
    with open(pre + ".sam") as fh:
        got = {f[0]: f[5] for f in (line.split("\t") for line in fh
                                    if not line.startswith("@"))}
    cfg = AlignConfig()
    want = {}
    for i, it in enumerate(_items(contig, reads)):
        want[f"lr{i}"] = finalize_cigar(golden_align_native(
            it.ref, it.seq, it.cigar, sub_scores, np_scores, cfg),
            it.ref, it.seq)
    assert got == want
