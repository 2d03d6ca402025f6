"""A whole-genome minimap2 BAM (npore_tpu_torch/testing/genome_reads.py),
in its reduced form, through the port on the CPU: the generator and its
records, the BAM read back, and the realign CLI held to the JAX package's
CLI, to the C++ golden aligner, to itself over two ranks, and on reads
across an assembly gap to the JAX package's Pallas engine.

Tolerance: exact throughout (byte-equal SAM and .npy files, equal records,
CIGARs and buffers).

The JAX package's CLI (``--engine golden``, about 100 s here) runs in a
subprocess started with the module, beside the other tests."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from npore_tpu.config import AlignConfig as JaxAlignConfig
from npore_tpu.engine.pallas_engine import PallasEngine
from npore_tpu.engine.realigner import AlignItem as JaxAlignItem
from npore_tpu_torch.cli import realign as cli
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.engine import windows as tw
from npore_tpu_torch.engine.bam_stream import SortedBamReader, confusion_counts
from npore_tpu_torch.engine.realigner import AlignItem, Realigner
from npore_tpu_torch.io.bam import BamReader
from npore_tpu_torch.io.bam_native import NativeBamReader
from npore_tpu_torch.io.cigar import finalize_cigar
from npore_tpu_torch.io.sam import SamRecord
from npore_tpu_torch.native import golden_align_native
from npore_tpu_torch.ops import npinfo_cuda
from npore_tpu_torch.parallel.distributed import host_out_path, shard_regions
from npore_tpu_torch.scripts import multihost_scaling as mh
from npore_tpu_torch.testing import chunks, genome_reads as gr

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = gr.REDUCED
SKIP = 0x904                 # secondary, supplementary, unmapped
ARGV0 = ["realign"]          # both CLIs' sys.argv: the SAM's @PG CL
WINDOW_ROWS = 500            # the Pallas check cuts reads in such windows
STATS = ("subs", "nps", "inss", "dels")
RECALC = "--- recalc ---"     # the JAX run's stdout: realign above, recalc below

# the JAX package's CLI on a BAM: realign (--engine golden), then
# --recalc_cms --recalc_exit into a fresh stats directory
JAX_RUN = """
import sys

sys.path.insert(0, {repo!r})

import jax

jax.config.update("jax_platforms", "cpu")

from npore_tpu.cli.realign import main

if __name__ == "__main__":
    bam, ref, out, stats, new_stats = sys.argv[1:]
    sys.argv = {argv0!r}
    io = ["--bam", bam, "--ref", ref, "--out_prefix", out]
    main(io + ["--stats_dir", stats, "--engine", "golden"])
    print({mark!r}, flush=True)
    main(io + ["--stats_dir", new_stats, "--recalc_cms", "--recalc_exit"])
""".format(repo=REPO, argv0=ARGV0, mark=RECALC)


@pytest.fixture(scope="module")
def genome():
    return gr.make_genome_reads(gr.SEED, LAYOUT)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("genome_reads")


@pytest.fixture(scope="module")
def written(genome, workdir):
    """(FASTA, BAM) of ``genome``."""
    return gr.write_genome_reads(str(workdir), genome)


@pytest.fixture(scope="module", autouse=True)
def jax_cli(genome, workdir, stats_dir):
    """The JAX package's CLI on ``genome`` with the MD tags taken off its
    secondary records, in a subprocess that runs while the module's other
    tests do: a function that waits for it and returns (SAM path, the
    realign run's stdout, stats directory).

    Both CLIs drop secondary records before they realign or count, so the
    SAM and counts they should write are those of ``written``; but the
    JAX package's C++ decoder preps every record it builds, and its prep
    of a record with SEQ '*' and an MD tag reads past an empty buffer
    (``test_cli_survives_a_secondary_record_first``)."""
    d = workdir / "jax"
    d.mkdir()
    g = dataclasses.replace(genome, reads=[
        dataclasses.replace(r, tags={k: v for k, v in r.tags.items()
                                     if k != "MD"})
        if r.kind == gr.SECONDARY else r for r in genome.reads])
    written = gr.write_genome_reads(str(d), g)
    script = d / "jax_cli_run.py"
    script.write_text(JAX_RUN)
    log = open(d / "stdout.txt", "w")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(script), *written[::-1], str(d / "out"),
         stats_dir, str(d / "stats")], cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)

    def result():
        rc = proc.wait(timeout=1200)
        log.flush()
        text = (d / "stdout.txt").read_text()
        assert rc == 0, text[-3000:]
        return str(d / "out.sam"), text.split(RECALC)[0], str(d / "stats")
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


def _warnings(text):
    return [line for line in text.splitlines() if line.startswith("WARNING")]


@pytest.fixture(scope="module")
def port_cli(written, workdir, stats_dir):
    """The port's CLI with --engine torch on ``written`` in this process,
    with the JAX run's sys.argv: (SAM path, stdout, the Realigner)."""
    import contextlib
    import io
    out = str(workdir / "port")
    log = io.StringIO()
    argv = sys.argv
    sys.argv = ARGV0
    try:
        with contextlib.redirect_stdout(log):
            rl = cli.run(["--bam", written[1], "--ref", written[0],
                          "--out_prefix", out, "--stats_dir", stats_dir,
                          "--engine", "torch"])
    finally:
        sys.argv = argv
    return out + ".sam", log.getvalue(), rl


def _truth(genome, r):
    """The realignment inputs of record ``r``: its reference span (N as
    0), its clip-cut bases and the extended CIGAR the CLI decodes."""
    return (bases_to_int(genome.fasta[r.rname][r.pos:r.pos + r.span]),
            bases_to_int(r.aligned_seq), r.cli_cigar)


# -- the generator ---------------------------------------------------------

def test_generator_is_seeded(genome):
    assert gr.make_genome_reads(gr.SEED, LAYOUT) == genome
    assert gr.make_genome_reads(gr.SEED + 1, LAYOUT).reads != genome.reads


def test_record_counts_and_order(genome):
    """Each kind of record as many times as the layout says, with its
    flags, in a coordinate sort's order with the unmapped last."""
    n = gr.counts(genome)
    L = LAYOUT
    assert n[gr.PRIMARY] + n[gr.NO_MD] + n[gr.M_OPS] == L.primary
    assert (n[gr.NO_MD], n[gr.M_OPS], n[gr.DECOY], n[gr.SUPPLEMENTARY],
            n[gr.SECONDARY], n[gr.UNMAPPED]) == (
        L.no_md, L.m_ops, L.decoy_reads, L.supplementary, L.secondary,
        L.unmapped)
    flags = {k: {r.flag for r in genome.reads if r.kind == k} for k in n}
    for k in (gr.PRIMARY, gr.NO_MD, gr.M_OPS, gr.DECOY):
        assert flags[k] <= {0, 16}
    assert flags[gr.SUPPLEMENTARY] <= {2048, 2064}
    assert flags[gr.SECONDARY] <= {256, 272}
    assert flags[gr.UNMAPPED] == {4}
    rid = {name: i for i, (name, _) in enumerate(genome.header)}
    mapped = [r for r in genome.reads if r.kind != gr.UNMAPPED]
    assert genome.reads[len(mapped):] == [r for r in genome.reads
                                          if r.kind == gr.UNMAPPED]
    keys = [(rid[r.rname], r.pos) for r in mapped]
    assert keys == sorted(keys)
    assert genome.header[-2:] == [L.unplaced, L.decoy]
    assert L.unplaced[0] in genome.fasta and L.decoy[0] not in genome.fasta
    assert not any(r.rname == L.unplaced[0] for r in genome.reads)
    assert {r.rname for r in genome.reads if r.kind == gr.DECOY} == \
        {L.decoy[0]}
    primary = [r for r in genome.reads if r.flag & SKIP == 0]
    assert {r.flag for r in primary} == {0, 16}
    assert any(r.clips[0] and r.clips[1] for r in primary)
    assert any(r.clips == (0, 0) for r in primary)
    assert {r.mapq for r in primary} == {0, 60}
    assert {r.tags["HP"][1] for r in primary if "HP" in r.tags} == {1, 2}
    assert any("HP" not in r.tags for r in primary)
    assert all(len(r.qual) == len(r.seq) and len(set(r.qual)) > 5
               for r in primary)
    assert all(r.seq == r.qual == "*" for r in genome.reads
               if r.kind == gr.SECONDARY)


def test_supplementary_and_secondary_records(genome):
    """Supplementary records hard-clip and name their primary in SA,
    which names them back; secondary records soft-clip; both share a
    primary read's name."""
    primary = {r.qname: r for r in genome.reads
               if r.kind in (gr.PRIMARY, gr.NO_MD, gr.M_OPS, gr.DECOY)}
    for r in genome.reads:
        if r.kind == gr.SUPPLEMENTARY:
            p = primary[r.qname]
            lead, tail = r.hard_clips
            assert lead and r.clips == (0, 0)
            assert r.cigar.startswith(f"{lead}H") and "S" not in r.cigar
            assert r.cigar.endswith(f"{tail}H") == (tail > 0)
            assert len(r.seq) == len(r.ecigar) - r.ecigar.count("D")
            assert r.tags["SA"][1].startswith(f"{p.rname},{p.pos + 1},")
            assert f"{r.rname},{r.pos + 1}," in p.tags["SA"][1]
        elif r.kind == gr.SECONDARY:
            assert r.qname in primary and "H" not in r.cigar
            assert "MD" in r.tags


def test_contigs_and_gaps(genome):
    """N stands exactly at the gaps: the first contig's lead, one short
    gap on each later contig but chrM and a long one on some; chrM and
    the unplaced contig hold none."""
    L = LAYOUT
    for i, (name, n) in enumerate(L.contigs):
        seq = genome.fasta[name]
        assert len(seq) == n
        gaps = genome.gaps[name]
        at = np.flatnonzero(np.frombuffer(seq.encode(), np.uint8)
                            == ord("N"))
        assert at.tolist() == [p for s, e in gaps for p in range(s, e)]
        if i == 0:
            assert gaps == [(0, L.lead_n)]
        elif name == "chrM":
            assert gaps == []
        else:
            assert 1 <= len(gaps) <= 2
            (s, e), rest = gaps[0], gaps[1:]
            assert L.short_gap[0] <= e - s <= L.short_gap[1]
            for s, e in rest:
                assert L.long_gap[0] <= e - s <= L.long_gap[1]
    assert "N" not in genome.fasta[L.unplaced[0]]
    assert any(len(g) == 2 for g in genome.gaps.values())


def test_reads_against_the_contigs(genome):
    """Each read's CIGAR covers its span of the contig: '=' where the
    read's base is the contig's, X where not. A read across a short gap
    holds a random base (X) or a deletion at each N, and its MD the N;
    every other read covers no N. On each contig a read starts at its
    first base (where that is not N) and one ends at its last."""
    fasta = dict(genome.fasta)
    spanning = 0
    for r in genome.reads:
        if r.kind in (gr.UNMAPPED, gr.DECOY):
            continue
        ref = np.frombuffer(fasta[r.rname][r.pos:r.pos + r.span].encode(),
                            np.uint8)
        assert len(ref) == r.span
        c = np.frombuffer(r.ecigar.encode(), np.uint8)
        if r.kind != gr.SECONDARY:
            q = np.frombuffer(r.aligned_seq.encode(), np.uint8)
            assert len(q) == int((c != ord("D")).sum())
            on = c[c != ord("I")]
            qr = q[c[c != ord("D")] != ord("I")]
            kept = on != ord("D")
            assert np.array_equal(qr == ref[kept], on[kept] == ord("="))
            assert ord("N") not in q
        has_n = ord("N") in ref
        assert has_n == r.spans_gap
        if r.spans_gap:
            spanning += 1
            assert "N" in r.tags["MD"][1]
    assert spanning == LAYOUT.n_spanning
    for name, n in LAYOUT.contigs:
        on = [r for r in genome.reads if r.rname == name
              and r.kind in (gr.PRIMARY, gr.NO_MD, gr.M_OPS)]
        assert any(r.pos + r.span == n for r in on), name
        if genome.fasta[name][0] != "N":
            assert any(r.pos == 0 for r in on), name


def test_md_tags_rebuild_the_contigs(genome):
    """Every MD tag, with its record's bases and CIGAR, gives back the
    contig under the record (the port's SamRecord), M ops included."""
    seen = 0
    for r in genome.reads:
        if "MD" not in r.tags or r.kind in (gr.SECONDARY, gr.DECOY):
            continue
        rec = SamRecord(qname=r.qname, flag=r.flag, rname=r.rname,
                        pos=r.pos, mapq=r.mapq, cigar=r.cigar, seq=r.seq,
                        qual=r.qual, tags=r.tags)
        assert rec.get_reference_sequence() == \
            genome.fasta[r.rname][r.pos:r.pos + r.span]
        seen += 1
    assert seen == LAYOUT.primary - LAYOUT.no_md + LAYOUT.supplementary


# -- the BAM ---------------------------------------------------------------

def _fields(r):
    return (r.qname, r.flag, r.rname, r.pos, r.mapq, r.cigar, r.seq, r.qual,
            r.tags)


def test_bam_reads_back(genome, written):
    """The BAM reads back as generated through the port's C++ decoder
    (without the prep, which a secondary record with MD crashes; below)
    and its pure-Python reader, header included."""
    native = NativeBamReader(written[1], prep=False)
    py = BamReader(written[1])
    assert native.references == py.references == [n for n, _ in
                                                   genome.header]
    assert native.lengths == py.lengths == [n for _, n in genome.header]
    assert "@PG\tID:minimap2" in native.header_text
    got = [_fields(r) for r in native]
    assert got == [_fields(r) for r in py]
    assert got == [_fields(r) for r in genome.reads]


def test_primary_reader_preps_only_what_is_realigned(genome, written):
    """The CLI's reader decodes only primary mapped records, each with the
    realignment inputs the generator made it from (the MD-less ones with
    none), contig by contig as the CLI fetches them."""
    reader = cli.open_bam(written[1], skip_flags=cli.SKIP_FLAGS)
    assert isinstance(reader, SortedBamReader)
    got = []
    for name, n in genome.header:
        got += list(reader.fetch(name, 0, n - 1))
    want = [r for r in genome.reads if r.flag & SKIP == 0]
    assert [g.qname for g in got] == [r.qname for r in want]
    for g, r in zip(got, want):
        if r.kind == gr.NO_MD:
            assert g.aln is None
            continue
        ref = bases_to_int(genome.fasta[r.rname][r.pos:r.pos + r.span]) \
            if r.rname in genome.fasta else g.aln[0]
        assert np.array_equal(g.aln[0], ref)
        assert np.array_equal(g.aln[1], bases_to_int(r.aligned_seq))
        assert g.aln[2] == r.cli_cigar


def test_cli_survives_a_secondary_record_first(genome, tmp_path,
                                               stats_dir):
    """A BAM whose first record is a secondary alignment with SEQ '*' and
    an MD tag: the C++ decoder's prep of it read through a null pointer
    (SIGSEGV) when the CLI counted the regions and fetched the reads; the
    CLI now counts without the prep and reads through a decoder that
    drops such records before it preps them.
    In a subprocess, so that a crash fails only this test."""
    sec = next(r for r in genome.reads if r.kind == gr.SECONDARY)
    rest = [r for r in genome.reads if r.rname == sec.rname
            and r.pos >= sec.pos and r is not sec]
    g = dataclasses.replace(genome, reads=[sec] + rest)
    fasta, bam = gr.write_genome_reads(str(tmp_path), g)
    pre = str(tmp_path / "out")
    res = subprocess.run(
        [sys.executable, "-m", "npore_tpu_torch.cli.realign", "--bam", bam,
         "--ref", fasta, "--out_prefix", pre, "--stats_dir", stats_dir,
         "--engine", "golden", "--max_reads", "2"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    with open(pre + ".sam") as fh:
        out = [line.split("\t") for line in fh if not line.startswith("@")]
    first = [r for r in rest if r.flag & SKIP == 0][:2]
    assert [f[0] for f in out] == [r.qname for r in first
                                   if r.kind != gr.NO_MD]
    assert all(int(f[1]) & SKIP == 0 for f in out)


# -- the realign CLI -------------------------------------------------------

def test_cli_records_carry_the_input(genome, port_cli, score_matrices):
    """One record for each primary mapped read with MD on a FASTA contig,
    in the BAM's order: its FLAG, POS, MAPQ and HP (0 where it had none)
    carried, SEQ and QUAL with the soft clips cut, and the CIGAR the C++
    golden aligner's, finalized; no record of another kind."""
    sub_scores, np_scores, _, _ = score_matrices
    sam, _, rl = port_cli
    assert rl.bail_count == 0
    with open(sam) as fh:
        out = [line.rstrip("\n").split("\t") for line in fh
               if not line.startswith("@")]
    want = gr.expected_output(genome)
    assert [f[0] for f in out] == [r.qname for r in want]
    assert {r.kind for r in want} == {gr.PRIMARY, gr.M_OPS}
    cfg = AlignConfig()
    for f, r in zip(out, want):
        ref, seq, cig = _truth(genome, r)
        gold = finalize_cigar(golden_align_native(
            ref, seq, cig, sub_scores, np_scores, cfg), ref, seq)
        hp = r.tags["HP"][1] if "HP" in r.tags else 0
        assert f == [r.qname, str(r.flag), r.rname, str(r.pos + 1),
                     str(r.mapq), gold, "*", "0", str(r.span),
                     r.aligned_seq, r.aligned_qual, f"HP:i:{hp}"], r.qname


def _counted_regions(written, stats_dir):
    """The regions ``engine.regions.get_bam_regions`` keeps, counting the
    reads of each contig, for a default call on ``written``."""
    from npore_tpu_torch.engine.regions import get_bam_regions
    from npore_tpu_torch.io.fasta import FastaFile
    cfg = cli.config_from_args(cli.argparser().parse_args(
        ["--bam", written[1], "--ref", written[0], "--out_prefix", "x",
         "--stats_dir", stats_dir]))
    return cfg, get_bam_regions(cfg, FastaFile(cfg.ref),
                                cli.open_bam(cfg.bam, prep=False))


def test_header_regions_write_the_counted_regions_sam(written, port_cli,
                                                      tmp_path, stats_dir):
    """A default single-rank call that loads its tables takes its regions
    from the BAM's header, without counting reads: the FASTA's contigs
    with reads and ``chrUn_1`` without. Its SAM is byte for byte that of
    a call given, by --contigs, the contigs the count keeps, and it still
    warns of the decoy contig."""
    import contextlib
    import io
    from npore_tpu_torch.io.fasta import FastaFile
    cfg, counted = _counted_regions(written, stats_dir)
    with_reads = [name for name, _ in LAYOUT.contigs]
    assert [c for c, _, _ in counted] == with_reads
    header = cli.select_regions(cfg, FastaFile(cfg.ref),
                                cli.open_bam(cfg.bam, prep=False), False)
    assert [c for c, _, _ in header] == with_reads + [LAYOUT.unplaced[0]]
    assert header[:len(counted)] == counted
    out = str(tmp_path / "contigs")
    argv = sys.argv
    sys.argv = ARGV0
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.run(["--bam", written[1], "--ref", written[0],
                     "--out_prefix", out, "--stats_dir", stats_dir,
                     "--engine", "torch", "--contigs", ",".join(with_reads)])
    finally:
        sys.argv = argv
    with open(port_cli[0], "rb") as a, open(out + ".sam", "rb") as b:
        assert a.read() == b.read()
    assert (f"WARNING: contig '{LAYOUT.decoy[0]}' in BAM but not FASTA, "
            f"skipping") in _warnings(port_cli[1])


def test_two_ranks_equal_one(written, port_cli, tmp_path, stats_dir):
    """The CLI as two ranks on gloo (five regions: region shards) writes
    the one-rank SAM's records, merged. The ranks count the reads of each
    contig, so each realigns its shard of the counted regions, which
    leave out ``chrUn_1``."""
    pre = str(tmp_path / "two")
    row = mh.run_ranks(2, ["--bam", written[1], "--ref", written[0],
                           "--stats_dir", stats_dir, "--engine", "torch",
                           "--out_prefix", pre], str(tmp_path), "two")
    one = mh.records(port_cli[0])
    assert [r["bails"] for r in row["ranks"]] == [0, 0]
    assert all(r["reads"] > 0 for r in row["ranks"])
    assert row["reads"] == len(one)
    assert mh.records(pre + ".sam") == one
    _, counted = _counted_regions(written, stats_dir)
    assert len(counted) == len(LAYOUT.contigs)
    for h in range(2):
        shard = shard_regions(counted, 2, h)
        with open(tmp_path / f"two.rank{h}.log") as fh:
            assert f"host {h}/2: {len(shard)} region shards" in fh.read()
        got = {r.split("\t")[2] for r in
               mh.records(host_out_path(pre, h, 2)).values()}
        assert got == {c for c, _, _ in shard}, h


# -- reads across an assembly gap ------------------------------------------

@pytest.fixture(scope="module")
def gap_reads(genome):
    """Four clipped reverse-strand reads whose span holds reference N."""
    picked = [r for r in genome.reads if r.spans_gap and r.flag == 16
              and r.clips != (0, 0) and r.kind == gr.PRIMARY][:4]
    assert len(picked) == 4
    return [AlignItem(*_truth(genome, r)) for r in picked]


def test_gap_reads_match_pallas_and_golden(score_matrices, gap_reads):
    """Across reference N, in windows of 500 rows: the port's engine
    (torch) gives the C++ golden aligner's CIGARs and the JAX package's
    PallasEngine's (interpret mode); that engine's trimmed ladder bails
    on some windows and realigns those reads with its golden fallback,
    and each window its kernels finished equals the port's window."""
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig(max_b_rows=WINDOW_ROWS)
    n_windows = [tw.build_windows(it.ref, it.seq, it.cigar, cfg)
                 for it in gap_reads]
    assert all(any((w.ref[:w.n_del] == 0).any() for w in ws)
               for ws in n_windows)
    eng = Realigner(sub_scores, np_scores, cfg, engine="torch")
    got = eng.align_batch(gap_reads)
    assert eng.bail_count == 0
    assert got == [golden_align_native(it.ref, it.seq, it.cigar, sub_scores,
                                       np_scores, cfg) for it in gap_reads]

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
                               for it in gap_reads]) == got
    assert finished
    for (i, ci), cig in finished:
        inss, dels, breaks = chunks.breaks_of(gap_reads[i].cigar, cfg)
        b, e = breaks[ci], breaks[ci + 1]
        assert cig == chunks.chunk_of(got[i], int(inss[b]), int(dels[b]),
                                      int(inss[e]), int(dels[e]))


def test_plain_scan_equals_pack_group_on_n_windows(gap_reads):
    """The windows of those reads that hold reference N, as one group:
    fill_group's prefix plus K4's plain version give pack_group's buffer
    byte for byte, on a zeroed buffer and on one of 0xA5 bytes."""
    cfg = AlignConfig(max_b_rows=WINDOW_ROWS)
    wins = [w for i, it in enumerate(gap_reads)
            for w in tw.build_windows(it.ref, it.seq, it.cigar, cfg,
                                      aln_idx=i)
            if (w.ref[:w.n_del] == 0).any()]
    assert len(wins) >= 4
    R = max(w.b_rows for w in wins)
    want, layout = tw.pack_group(wins, R, cfg.max_n)
    head = tw.fill_group(wins, R, cfg.max_n)
    off = tw.prefix_nbytes(layout)
    for fill in (0, 0xA5):
        buf = torch.full((tw.group_nbytes(layout),), fill, dtype=torch.uint8)
        buf[:off] = torch.from_numpy(head)
        n0 = npinfo_cuda.launches
        npinfo_cuda.fill_planes(tw.tensor_views(buf, layout), cfg)
        assert npinfo_cuda.launches == n0         # the plain version
        got = buf.numpy()
        if fill == 0:
            assert np.array_equal(got, want)
        for k, o, shape, dt in layout:
            n = int(np.prod(shape)) * dt.itemsize
            assert np.array_equal(got[o:o + n], want[o:o + n]), k


# -- against the JAX package's CLI (its subprocess ran beside the above) --

def test_cli_writes_the_jax_clis_sam(jax_cli, port_cli):
    """The port's CLI (--engine torch) writes the JAX package's CLI's SAM
    (--engine golden) byte for byte, with the same warnings: the decoy
    contig missing from the FASTA and each MD-less read skipped."""
    jax_sam, jax_out, _ = jax_cli()
    sam, out, rl = port_cli
    with open(sam, "rb") as a, open(jax_sam, "rb") as b:
        assert a.read() == b.read()
    assert _warnings(out) == _warnings(jax_out)
    assert len(rl.skipped) == LAYOUT.no_md
    assert f"contig '{LAYOUT.decoy[0]}' in BAM but not FASTA" in out


def test_recalc_equals_jax_on_one_and_two_ranks(jax_cli, written,
                                                tmp_path):
    """--recalc_cms --recalc_exit: the port's .npy files equal the JAX
    CLI's, from one rank and from two ranks on gloo (region shards, the
    counts all-reduced)."""
    cli_args = ["--bam", written[1], "--ref", written[0], "--engine",
                "torch", "--recalc_cms", "--recalc_exit"]
    got = {}
    for n in (1, 2):
        d = str(tmp_path / f"stats{n}")
        row = mh.run_ranks(n, cli_args + ["--stats_dir", d, "--out_prefix",
                                          str(tmp_path / f"o{n}")],
                           str(tmp_path), f"recalc{n}")
        assert [r["loaded"] for r in row["ranks"]] == [[]] * n
        got[n] = {k: np.load(os.path.join(d, f"{k}_cm.npy")) for k in STATS}
    _, _, jax_stats = jax_cli()
    for k in STATS:
        want = np.load(os.path.join(jax_stats, f"{k}_cm.npy"))
        assert got[1][k].dtype == want.dtype
        assert np.array_equal(got[1][k], want), k
        assert np.array_equal(got[2][k], want), k
    assert got[1]["subs"].sum() > 0


# -- the sorted reader -----------------------------------------------------

def _decoder_sorted(reader):
    return reader._lib.bamio_sorted(reader._h)


def _ranges(genome, width):
    return [(name, s, min(n - 1, s + width)) for name, n in genome.header
            for s in range(0, n - 1, width)]


def test_region_count_keeps_the_decoder_sorted(genome, written):
    """The CLI's region count over every contig leaves the C++ decoder
    taking the BAM for sorted. The decoder's own fetch seeks back past the
    last record it saw (native/bamio.cpp:550-553), declares the BAM
    unsorted, and from then on decodes the whole file for every fetch."""
    reader = cli.open_bam(written[1], prep=False)
    counts = [reader.count(name, 0, n - 1) for name, n in genome.header]
    assert _decoder_sorted(reader) == 1
    fresh = [NativeBamReader(written[1], prep=False).count(name, 0, n - 1)
             for name, n in genome.header]
    assert counts == fresh
    seeking = NativeBamReader(written[1], prep=False)
    assert [seeking.count(name, 0, n - 1)
            for name, n in genome.header] == fresh
    assert _decoder_sorted(seeking) == 0


@pytest.mark.parametrize("order", ["file", "reversed", "shuffled"])
def test_sorted_reader_fetches_what_a_fresh_reader_does(genome, written,
                                                        order):
    """Ranges of 5 kb (reads of 1-2 kb cross their bounds) through one
    SortedBamReader: each fetch yields the records, in order, that a fresh
    reader's fetch of that range yields; in the file's order the decoder
    reads on and stays sorted, in any other order it seeks."""
    ranges = _ranges(genome, 5_000)
    if order == "reversed":
        ranges = ranges[::-1]
    elif order == "shuffled":
        ranges = [ranges[i] for i in
                  np.random.default_rng(3).permutation(len(ranges))]
    reader = SortedBamReader(written[1], prep=False)
    for c, s, e in ranges:
        got = [(r.qname, r.flag, r.pos) for r in reader.fetch(c, s, e)]
        want = [(r.qname, r.flag, r.pos) for r in
                NativeBamReader(written[1], prep=False).fetch(c, s, e)]
        assert got == want, (c, s, e)
    if order == "file":
        assert _decoder_sorted(reader) == 1


@pytest.mark.parametrize("processes", [1, 3])
def test_confusion_counts_equal_the_copys(genome, written, processes):
    """The CLI's training counts (runs of consecutive 20 kb ranges, one a
    worker) equal engine.stats.calc_confusion_matrices_bam's."""
    from npore_tpu_torch.config import RealignConfig
    from npore_tpu_torch.engine.stats import calc_confusion_matrices_bam
    from npore_tpu_torch.io.fasta import FastaFile
    cfg = RealignConfig(bam=written[1], ref=written[0], chunk_width=20_000)
    fa = FastaFile(written[0])
    regions = [(n, 0, ln - 1) for n, ln in LAYOUT.contigs]
    got = confusion_counts(written[1], fa, regions, cfg, processes)
    want = calc_confusion_matrices_bam(written[1], fa, regions, cfg, 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert want[0].sum() > 0
