"""The port's BED, filter and purity CLIs against the JAX package's, on the
fixtures of tests/test_cli_bed_purity.py and tests/test_vcf_tools.py: the
same BED and VCF files byte for byte, and the same purity scores."""
import os

import numpy as np
import pytest
import torch

from npore_tpu.cli import bed as jbed
from npore_tpu.cli import filter as jfilter
from npore_tpu.cli import purity as jpur
from npore_tpu_torch.cli import bed as tbed
from npore_tpu_torch.cli import filter as tfilter
from npore_tpu_torch.cli import purity as tpur

torch.set_num_threads(2)

VCF_HEAD = ("##fileformat=VCFv4.2\n"
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
OVERLAPS = VCF_HEAD + (
    "c\t3\t.\tATTTTTTT\tA\t60\tPASS\t.\tGT\t1|1\n"
    "c\t5\t.\tT\tC\t60\tPASS\t.\tGT\t1|1\n"
    "c\t6\t.\tTTTT\tT\t60\tPASS\t.\tGT\t1|1\n"
    "c\t12\t.\tG\tC\t60\tPASS\t.\tGT\t1|1\n")
GENOTYPES = VCF_HEAD + (
    "c\t3\t.\tA\tC\t60\tPASS\t.\tGT:GQ\t0/0:12\n"
    "c\t5\t.\tT\tC\t60\tPASS\t.\tGT\t0|0\n"
    "c\t8\t.\tG\tC\t60\tPASS\t.\tGT\t0/1\n"
    "c\t12\t.\tG\tC\t60\tPASS\t.\tGT\t1|1\n")


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _bed_run(main, d, ref, length, argv):
    os.makedirs(d)
    bed = os.path.join(d, "genome.bed")
    with open(bed, "w") as fh:
        fh.write(f"ref\t0\t{length}\n")
    assert main(["--ref", ref, "--bed", bed, "--out_prefix",
                 os.path.join(d, "np")] + argv) == 0
    return d


@pytest.mark.parametrize("mode", ["serial", "chunked"])
@pytest.mark.parametrize("max_n", [3, 6])
def test_bed_files_equal_jax(tmp_path, data_dir, max_n, mode):
    ref = os.path.join(data_dir, "ref.fasta")
    with open(ref) as fh:
        length = sum(len(l.strip()) for l in fh if not l.startswith(">"))
    argv = ["--max_n", str(max_n)]
    if mode == "chunked":
        argv += ["--chunk_width", "200", "--processes", "3"]
    got = _bed_run(tbed.main, str(tmp_path / "t"), ref, length, argv)
    want = _bed_run(jbed.main, str(tmp_path / "j"), ref, length, argv)
    names = [f"np_{n}.bed" for n in range(max_n + 1)] + ["np_all.bed",
                                                         "genome.genome"]
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in names:
        assert _bytes(os.path.join(got, name)) == _bytes(
            os.path.join(want, name)), name
    assert os.path.getsize(os.path.join(got, "np_1.bed")) > 0


@pytest.mark.parametrize("suffix", [".vcf", ".vcf.gz"])
@pytest.mark.parametrize("case", ["overlaps", "exclude_gt", "std_fixture"])
def test_filter_outputs_equal_jax(tmp_path, data_dir, case, suffix):
    if case == "std_fixture":
        vcf, argv = os.path.join(data_dir, "test_std_vcf.vcf"), []
    else:
        vcf = str(tmp_path / "in.vcf")
        with open(vcf, "w") as fh:
            fh.write(OVERLAPS if case == "overlaps" else GENOTYPES)
        argv = ["--exclude_gt", "0/0"] if case == "exclude_gt" else []
    got, want = str(tmp_path / f"t{suffix}"), str(tmp_path / f"j{suffix}")
    assert tfilter.main([vcf, got] + argv) == 0
    assert jfilter.main([vcf, want] + argv) == 0
    assert _bytes(got) == _bytes(want)
    if suffix == ".vcf.gz":
        assert _bytes(got + ".tbi") == _bytes(want + ".tbi")
    elif case == "overlaps":
        with open(got) as fh:
            assert [l.split("\t")[1] for l in fh
                    if not l.startswith("#")] == ["3", "12"]


@pytest.fixture(scope="module")
def host_scores(data_dir):
    bam = os.path.join(data_dir, "reads.bam")
    return jpur.bam_purity(bam, None, None, None, 13, processes=1)


@pytest.mark.parametrize("device", [False, "cpu"])
def test_bam_purity_equals_jax_host(data_dir, host_scores, device):
    bam = os.path.join(data_dir, "reads.bam")
    got = tpur.bam_purity(bam, None, None, None, 13, processes=1,
                          device=device)
    assert got.shape == host_scores.shape and len(got) > 0
    assert np.allclose(got, host_scores, rtol=0, atol=1e-12)
    if device is False:
        assert np.array_equal(got, host_scores)


def test_purity_device_columns(host_scores):
    """The crafted column and the deep-insertion fallback of
    test_purity_device_matches_host, with the moments on the CPU."""
    col = "".join(f"A+{len(s)}{s}" for s in
                  ("T", "TT", "TTT", "GG", "GGG", "C", "CC", "CCC", "AAC"))
    assert tpur.column_counts(col) is None
    assert tpur.compute_purity(col) == jpur.compute_purity(col)
    b, iv = tpur.column_counts("^KA$AA+2TTC")
    got = tpur.purity_from_moments(
        *tpur.gini_moments_device(b[None], iv[None], "cpu"))[0]
    want = jpur.compute_purity("^KA$AA+2TTC")
    assert np.allclose(got, want, atol=1e-15)


def test_gini_moments_equal_jax():
    """int32 moments element for element, up to n = 46,000 a column."""
    rng = np.random.default_rng(4)
    b = rng.integers(0, 9201, (4096, 5)).astype(np.int32)
    iv = np.zeros((4096, tpur.INS_SLOTS), np.int32)
    n = b.sum(1)
    for k in range(tpur.INS_SLOTS):
        iv[:, k] = rng.integers(0, np.maximum(n - iv.sum(1), 0) // 4 + 1)
    b[0] = [46_000, 0, 0, 0, 0]
    got = tpur.gini_moments_device(b, iv, "cpu")
    want = jpur.gini_moments_device(b, iv)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert got[1][0] == 46_000 ** 2


def test_purity_cli_equals_jax_and_caches(tmp_path, data_dir):
    bam = os.path.join(data_dir, "reads.bam")
    argv = ["--bams", f"{bam},{bam}", "--names", "a,b"]
    pre, jpre = str(tmp_path / "pur"), str(tmp_path / "jpur")
    assert tpur.main(argv + ["--out_prefix", pre]) == 0
    assert jpur.main(argv + ["--out_prefix", jpre]) == 0
    for name in ("a", "b"):
        scores = np.load(f"{pre}_{name}.npy")
        assert scores.ndim == 2 and scores.shape[1] == 2 and len(scores)
        assert (scores >= 0).all() and (scores <= 1).all()
        assert np.array_equal(scores, np.load(f"{jpre}_{name}.npy"))


def test_purity_cli_plot_only_uses_the_cache(tmp_path, data_dir):
    pytest.importorskip("matplotlib")
    bam = os.path.join(data_dir, "reads.bam")
    pre = str(tmp_path / "pur")
    assert tpur.main(["--bams", f"{bam},{bam}", "--names", "a,b",
                      "--out_prefix", pre, "--plot"]) == 0
    assert os.path.isfile(pre + "_purity.png")
    os.remove(pre + "_purity.png")
    assert tpur.main(["--bams", "missing1,missing2", "--names", "a,b",
                      "--out_prefix", pre, "--plot_only"]) == 0
    assert os.path.isfile(pre + "_purity.png")


def test_card_paths_raise_without_a_card(tmp_path, data_dir, stats_dir,
                                         monkeypatch):
    """``--engine cuda``, ``--device_gini`` and the moments' default device
    raise when torch sees no card; nothing falls back to the CPU."""
    from npore_tpu_torch.cli import standardize_vcf as tstd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tstd.main(["--vcf", os.path.join(data_dir, "test_std_vcf.vcf"),
                   "--ref", os.path.join(data_dir, "test_std_ref.fasta"),
                   "--out_prefix", str(tmp_path / "std"),
                   "--stats_dir", stats_dir])
    bam = os.path.join(data_dir, "reads.bam")
    with pytest.raises(RuntimeError, match="is_available"):
        tpur.main(["--bams", bam, "--out_prefix", str(tmp_path / "p"),
                   "--device_gini"])
    assert not os.path.exists(str(tmp_path / "p") + "_reads.bam.npy")
    b, iv = tpur.column_counts("AAC")
    with pytest.raises(RuntimeError, match="is_available"):
        tpur.gini_moments_device(b[None], iv[None])
