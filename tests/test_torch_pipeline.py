"""The port's shell pipelines executed against tests/mock_tools, as
tests/test_mock_pipeline.py runs the JAX package's: ``align.sh`` and one
full iteration of ``npore_tpu_torch/scripts/realign_pipeline.sh`` with
``NPORE_ENGINE=torch``, whose realigned records must carry the CIGARs of
tests/data/npore_realigned.sam. The mock tools stand in for minimap2,
samtools, whatshap, tabix and Clair3 and use the JAX package's host IO; the
port's own CLIs do the realignment, standardization and filtering."""
import os
import subprocess

import pytest
import torch

from npore_tpu_torch.io.bam import BamReader
from npore_tpu_torch.io.sam import SamReader
from npore_tpu_torch.io.vcf import VcfReader
from test_mock_pipeline import _make_pipeline_fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOCK = os.path.join(REPO, "tests", "mock_tools")
PORT = os.path.join(REPO, "npore_tpu_torch", "scripts")


@pytest.fixture(scope="module")
def native_cache(tmp_path_factory):
    """A cache of its own for the JAX package's C++ library, which the mock
    tools load: that library builds in place, and a cold shared cache can
    be half-written by another test process."""
    return str(tmp_path_factory.mktemp("npore_native"))


def _env(native_cache, engine="torch", **extra):
    env = dict(os.environ)
    env["PATH"] = MOCK + os.pathsep + env["PATH"]
    env["NPORE_PLATFORM"] = "cpu"
    env["NPORE_NATIVE_CACHE"] = native_cache
    env["OMP_NUM_THREADS"] = "2"
    env.pop("NPORE_ENGINE", None)
    if engine is not None:
        env["NPORE_ENGINE"] = engine
    env.update(extra)
    return env


def test_port_align_sh_executes(data_dir, tmp_path, native_cache):
    """The port's align.sh (a copy of scripts/align.sh): minimap2 (canned)
    -> sort -> calmd -> index, 10 sorted records with MD tags."""
    out = str(tmp_path / "aln")
    r = subprocess.run(
        ["bash", os.path.join(PORT, "align.sh"),
         os.path.join(data_dir, "reads.fastq"),
         os.path.join(data_dir, "ref.fasta"), out],
        env=_env(native_cache,
                 MOCK_MINIMAP2_SAM=os.path.join(data_dir, "reads.sam")),
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.exists(out + ".bam") and os.path.exists(out + ".bam.bai")
    recs = list(BamReader(out + ".bam"))
    assert len(recs) == 10 and all(r_.has_tag("MD") for r_ in recs)
    assert all(recs[i].pos <= recs[i + 1].pos for i in range(len(recs) - 1))


def _pipeline(data_dir, wd, env, **stages):
    """Run the port's realign_pipeline.sh on the fixtures of
    tests/test_mock_pipeline.py, written into ``wd``."""
    genome, calls_path = _make_pipeline_fixtures(data_dir, wd)
    env = dict(env, TRAIN_CHRS="ref", TEST_CHRS="ref2",
               CLAIR3_DIR=os.path.join(MOCK, "clair3"),
               CLAIR3_MODEL="mock_model", MOCK_CLAIR3_VCF=calls_path,
               **stages)
    return subprocess.run(
        ["bash", os.path.join(PORT, "realign_pipeline.sh"),
         wd, os.path.join(data_dir, "reads.fastq"), genome,
         os.path.join(wd, "truth.vcf.gz"), os.path.join(wd, "truth.bed"),
         os.path.join(REPO, "guppy5_stats")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=900)


def test_port_realign_pipeline_full_iteration(data_dir, tmp_path,
                                              native_cache):
    """One full iteration with NPORE_ENGINE=torch (itr 0 std_ref/cand_call
    -> itr 1 rephase/std_ref/realign/cand_call -> terminal rephase/realign/
    var_call): the artifacts of tests/test_mock_pipeline.py's run, and the
    realigned records of 1_reads.bam equal the golden SAM's CIGARs."""
    wd = str(tmp_path / "wd")
    os.makedirs(wd)
    r = _pipeline(data_dir, wd, _env(native_cache),
                  STAGE_REPHASE="1", STAGE_STD_REF="1", STAGE_REALIGN="1",
                  STAGE_CAND_CALL="1", STAGE_VAR_CALL="1",
                  START_ITR="0", STOP_ITR="1")
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]

    must_exist = [
        "ref/0_std.vcf.gz",
        "1_candidates.vcf.gz", "1_allcalls.vcf.gz", "1_calls.vcf.gz",
        "1_phased.vcf.gz", "1_phased.bam", "1_phased_all.sam",
        "ref/1_phased.vcf.gz", "ref/1_std.vcf.gz",
        "1_reads.bam", "1_reads.bam.bai",
        "2_candidates.vcf.gz", "2_calls.vcf.gz",
        "2_phased.bam",
        "2_reads.bam",
        "2_variant_cands.vcf.gz", "2_variants.vcf.gz",
    ]
    for f in must_exist:
        assert os.path.exists(os.path.join(wd, f)), (f, r.stdout[-3000:])

    allcalls = list(VcfReader(os.path.join(wd, "1_allcalls.vcf.gz")))
    assert all(rec.gt != (0, 0) for rec in allcalls)
    assert len(allcalls) == 3

    phased = list(BamReader(os.path.join(wd, "1_phased.bam")))
    assert len(phased) == 10 and all(p.has_tag("HP") for p in phased)
    tagged = list(SamReader(os.path.join(wd, "1_phased_all.sam")))
    assert len(tagged) == 10 and all(p.has_tag("HP") for p in tagged)
    realigned = list(BamReader(os.path.join(wd, "1_reads.bam")))
    assert len(realigned) == 10
    assert all(p.has_tag("MD") for p in realigned)
    want = {rec.qname: rec.cigar for rec in SamReader(
        os.path.join(data_dir, "npore_realigned.sam"))}
    assert {rec.qname: rec.cigar for rec in realigned} == want

    std = list(VcfReader(os.path.join(wd, "ref/1_std.vcf.gz")))
    assert len(std) >= 2


def test_port_realign_pipeline_default_engine_needs_a_card(
        data_dir, tmp_path, native_cache):
    """With NPORE_ENGINE unset the pipeline realigns with --engine cuda,
    which fails without a card: the stage does not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    wd = str(tmp_path / "wd")
    os.makedirs(wd)
    os.symlink(os.path.join(data_dir, "reads.bam"),
               os.path.join(wd, "1_phased.bam"))
    r = _pipeline(data_dir, wd, _env(native_cache, engine=None),
                  STAGE_REALIGN="1", START_ITR="1", STOP_ITR="1")
    assert r.returncode != 0
    assert "realigning reads (itr 1)" in r.stdout
    assert "needs a CUDA device" in r.stderr, r.stderr[-2000:]
    assert not os.path.exists(os.path.join(wd, "1_reads.bam"))
