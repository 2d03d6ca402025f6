"""standardize_vcf of the port against the JAX package's CLI: the same
output files, byte for byte, from the port's golden and plain PyTorch
engines as from the JAX CLI's golden engine, on the checked-in fixture and
on a seeded contig whose indels sit in n-polymer runs."""
import gzip
import os
import tempfile

import numpy as np
import pytest
import torch

from npore_tpu.cli.standardize_vcf import main as jax_main
from npore_tpu_torch.cli import standardize_vcf as tstd
from npore_tpu_torch.config import AlignConfig
from npore_tpu_torch.constants import bases_to_int
from npore_tpu_torch.io.fasta import write_fasta
from npore_tpu_torch.io.vcf import (VcfReader, apply_vcf, make_header,
                                    split_vcf, write_vcf)
from npore_tpu_torch.native import golden_align_native
from npore_tpu_torch.testing import chunks, synth

torch.set_num_threads(2)

# every file a run writes, after its prefix
OUTPUTS = ("pre1.vcf.gz", "pre1.vcf.gz.tbi", "pre2.vcf.gz",
           "pre2.vcf.gz.tbi", "1.vcf.gz", "1.vcf.gz.tbi", "2.vcf.gz",
           "2.vcf.gz.tbi", ".vcf.gz", ".vcf.gz.tbi")


def _run(main, tmp_path, name, vcf, ref, stats_dir, engine):
    pre = str(tmp_path / name / "std")
    os.makedirs(os.path.dirname(pre))
    assert main(["--vcf", vcf, "--ref", ref, "--out_prefix", pre,
                  "--stats_dir", stats_dir, "--engine", engine]) == 0
    return pre


def _same_files(got_pre, want_pre):
    for suffix in OUTPUTS:
        with open(got_pre + suffix, "rb") as a, open(want_pre + suffix,
                                                     "rb") as b:
            assert a.read() == b.read(), suffix
    with gzip.open(got_pre + ".vcf.gz", "rt") as a, \
            gzip.open(want_pre + ".vcf.gz", "rt") as b:
        text = a.read()
        assert text == b.read()
    return text


@pytest.fixture(scope="module")
def seeded_contig(tmp_path_factory):
    """~1 kb contig (the plain DP stays under ~15 s on two threads) with
    ten truth sites, three of them indels of whole n-polymer units."""
    d = tmp_path_factory.mktemp("contig")
    rng = np.random.default_rng(3)
    genome, runs = synth.genome_with_runs(rng, 1000)
    recs = synth.truth_variants(rng, "ctg", genome, runs, per_kb=10,
                                indel_share=0.3)
    assert sum(len(r.alleles[0]) != len(r.alleles[1]) for r in recs) >= 2
    ref, vcf = str(d / "ctg.fasta"), str(d / "ctg.vcf")
    write_fasta(ref, {"ctg": genome})
    write_vcf(vcf, make_header([("ctg", len(genome))]), recs)
    return vcf, ref


def _inputs(name, data_dir, seeded_contig):
    if name == "fixture":
        return (os.path.join(data_dir, "test_std_vcf.vcf"),
                os.path.join(data_dir, "test_std_ref.fasta"))
    return seeded_contig


@pytest.mark.parametrize("name", ["fixture", "seeded"])
def test_port_engines_equal_jax_golden(tmp_path, data_dir, stats_dir,
                                       seeded_contig, name):
    vcf, ref = _inputs(name, data_dir, seeded_contig)
    want = _run(jax_main, tmp_path, "jax", vcf, ref, stats_dir, "golden")
    texts = []
    for engine in ("golden", "torch"):
        got = _run(tstd.main, tmp_path, engine, vcf, ref, stats_dir, engine)
        texts.append(_same_files(got, want))
    recs = list(VcfReader(want + ".vcf.gz"))
    assert len(recs) > 0 and texts[0] == texts[1]
    if name == "seeded":
        # standardization moved at least one indel of the truth set
        truth = {(r.pos, r.alleles) for r in VcfReader(vcf)
                 if len(r.alleles[0]) != len(r.alleles[1])}
        out = {(r.pos, r.alleles) for r in recs
               if len(r.alleles[0]) != len(r.alleles[1])}
        assert out and out != truth


@pytest.mark.parametrize("engine", ["golden", "torch"])
def test_std_vcf_cli_assertions_hold_on_the_port(tmp_path, data_dir,
                                                  stats_dir, engine):
    """tests/test_std_vcf_cli.py's assertions, on the port's output."""
    pre = _run(tstd.main, tmp_path, engine,
               os.path.join(data_dir, "test_std_vcf.vcf"),
               os.path.join(data_dir, "test_std_ref.fasta"), stats_dir,
               engine)
    assert os.path.exists(pre + ".vcf.gz.tbi")
    recs = list(VcfReader(pre + ".vcf.gz"))
    assert len(recs) >= 4
    keyed = {(r.contig, r.pos + 1, r.alleles): r.sample for r in recs}
    assert keyed.get(("chr19", 15, ("C", "G"))) == "1|1"
    chr18 = [r for r in recs if r.contig == "chr18"]
    assert any(len(r.alleles[1]) > len(r.alleles[0]) for r in chr18)
    assert all(r.sample in ("1|0", "0|1", "1|1") for r in recs)


def test_run_reports_the_engine_cigars(tmp_path, data_dir, stats_dir):
    """``run`` hands back the alignments and their CIGARs before
    normalization, one per haplotype and region, through the engine."""
    done = tstd.Realigned()
    rl = tstd.run(["--vcf", os.path.join(data_dir, "test_std_vcf.vcf"),
                   "--ref", os.path.join(data_dir, "test_std_ref.fasta"),
                   "--out_prefix", str(tmp_path / "std"), "--stats_dir",
                   stats_dir, "--engine", "torch"], done)
    assert rl.engine == "torch" and rl.bail_count == 0
    eng = rl._engine
    assert len(done.items) == len(done.cigars) == 4     # 2 contigs x 2 haps
    assert eng.windows == len(done.items) and eng.groups == 1
    for it, cig in zip(done.items, done.cigars):
        assert sum(c != "D" for c in cig) == len(it.seq)
        assert sum(c != "I" for c in cig) == len(it.ref)


@pytest.mark.parametrize("max_b_rows", [300, 1999])
def test_a_window_checks_on_its_own(score_matrices, max_b_rows):
    """testing.chunks: the golden aligner on one window's sub-alignment
    gives the window's part of the golden whole-haplotype CIGAR, for every
    window of both haplotypes of a seeded contig."""
    sub_scores, np_scores, _, _ = score_matrices
    cfg = AlignConfig(max_b_rows=max_b_rows)
    rng = np.random.default_rng(12)
    genome, runs = synth.genome_with_runs(rng, 6000)
    recs = synth.truth_variants(rng, "ctg", genome, runs, per_kb=8,
                                indel_share=0.5)
    regions = [("ctg", 0, len(genome) - 1)]
    with tempfile.TemporaryDirectory() as d:
        vcf = os.path.join(d, "t.vcf")
        write_vcf(vcf, make_header([("ctg", len(genome))]), recs)
        haps = [apply_vcf(v, h, regions, lambda ctg: genome)[0] for h, v in
                enumerate(split_vcf(vcf, regions, os.path.join(d, "p")), 1)]
    for _, _, seq, ref, cig in haps:
        r, s = bases_to_int(ref), bases_to_int(seq)
        full = golden_align_native(r, s, cig, sub_scores, np_scores, cfg)
        path = chunks.path_of(cig)
        inss, dels, breaks = chunks.breaks_of(cig, cfg)
        assert len(breaks) >= 4
        for ci in range(len(breaks) - 1):
            got, bounds = chunks.golden_window(r, s, path, inss, dels,
                                               breaks, ci, sub_scores,
                                               np_scores, cfg)
            assert got == chunks.chunk_of(full, *bounds)
