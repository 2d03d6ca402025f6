"""The port's genome-scale harness (``npore_tpu_torch/scripts/genome_scale.py``)
against the JAX script (``scripts/genome_scale.py``): byte-identical
fixtures, a reduced run on the plain PyTorch path in a fresh interpreter
(golden parity, chunk count, BED files byte-identical to the JAX bed
CLI's), and, slow-marked, the JAX reduced test's arguments through all
stages, whose standardized VCF must equal the golden engine's."""
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from npore_tpu_torch.scripts import genome_scale

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    """scripts/genome_scale.py, loaded by path (its build_fixtures imports
    only the JAX package's host IO)."""
    spec = importlib.util.spec_from_file_location(
        "jax_genome_scale", os.path.join(REPO, "scripts", "genome_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixtures_equal_jax_script(tmp_path):
    """--mbp 0.2 --reads 60 --seed 11: FASTA, BAM, VCF.gz and BED byte for
    byte."""
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    want = _jax_script().build_fixtures(str(tmp_path / "jax"), 0.2, 60, 11)
    got = genome_scale.build_fixtures(str(tmp_path / "port"), 0.2, 60, 11)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert os.path.getsize(w) > 0
        assert filecmp.cmp(g, w, shallow=False), os.path.basename(g)


def _run_script(argv):
    """``python -m npore_tpu_torch.scripts.genome_scale`` in a fresh
    interpreter: its JSON rows by stage, and what of jax and npore_tpu the
    run loaded."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['genome_scale'] + {argv!r}\n"
        "rc = 0\n"
        "try:\n"
        "    runpy.run_module('npore_tpu_torch.scripts.genome_scale', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'npore_tpu' or "
        "m.startswith('npore_tpu.'))\n"
        "print(json.dumps({'stage': 'loaded', 'rc': rc, 'loaded': bad}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=1500)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rows = {}
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            d = json.loads(line)
            rows[d["stage"]] = d
    assert rows["loaded"] == {"stage": "loaded", "rc": 0, "loaded": []}
    return rows


def test_reduced_run_on_the_cpu(tmp_path):
    """--mbp 0.3 --reads 100 --max_reads 12 --parity_sample 4 --stages
    realign,stats,bed --engine torch: parity 4/4, 0.3 Mbp / 100 kb + 1 = 4
    chunks, and the BED files the JAX bed CLI writes for the same FASTA and
    BED."""
    wd = str(tmp_path / "wd")
    rows = _run_script(["--mbp", "0.3", "--reads", "100", "--max_reads",
                        "12", "--parity_sample", "4", "--stages",
                        "realign,stats,bed", "--engine", "torch",
                        "--workdir", wd])
    for stage in ("generate", "realign", "parity", "stats", "bed",
                  "summary"):
        assert stage in rows, stage
    assert "std" not in rows
    assert rows["parity"] == {"stage": "parity", "sampled": 4, "ok": True}
    assert rows["stats"]["chunks"] == 4 and rows["stats"]["subs_total"] > 0
    assert rows["summary"]["engine"] == "torch"

    from npore_tpu.cli.bed import main as jax_bed
    tag = "g0.3m_r100_s11v2"
    jpre = str(tmp_path / "jax_bed")
    assert jax_bed(["--ref", os.path.join(wd, tag + ".fasta"),
                    "--out_prefix", jpre,
                    "--bed", os.path.join(wd, tag + ".bed")]) == 0
    names = sorted(f[len("jax_bed"):] for f in os.listdir(tmp_path)
                   if f.startswith("jax_bed"))
    assert "_all.bed" in names and "_6.bed" in names
    assert sorted(f[len("gs_bed"):] for f in os.listdir(wd)
                  if f.startswith("gs_bed")) == names
    for n in names:
        assert filecmp.cmp(os.path.join(wd, "gs_bed" + n), jpre + n,
                           shallow=False), n
    counts = {k: v for k, v in rows["bed"]["regions"].items()}
    with open(jpre + "_all.bed") as fh:
        assert counts["all"] == sum(1 for _ in fh) > 1000


@pytest.mark.slow
def test_genome_scale_reduced_all_stages(tmp_path):
    """The JAX reduced test's arguments (tests/test_genome_scale.py) with
    --engine torch through all five stages; the std stage's VCF equals
    the one standardize_vcf --engine golden writes for the same contig."""
    wd = str(tmp_path / "wd")
    rows = _run_script(["--mbp", "2", "--reads", "600", "--max_reads", "12",
                        "--parity_sample", "6", "--std_contig", "contig2",
                        "--engine", "torch", "--workdir", wd])
    for stage in ("generate", "realign", "parity", "stats", "bed", "std",
                  "summary"):
        assert stage in rows, stage
    assert rows["parity"]["ok"] and rows["parity"]["sampled"] == 6
    assert rows["stats"]["chunks"] == 21
    assert rows["stats"]["subs_total"] > 0
    assert rows["bed"]["regions"]["all"] > 1000
    assert rows["std"]["records"] >= 1

    from npore_tpu_torch.cli.standardize_vcf import main as std_main
    tag = "g2m_r600_s11v2"
    pre = str(tmp_path / "golden_std")
    assert std_main(["--vcf", os.path.join(wd, tag + ".vcf.gz"),
                     "--ref", os.path.join(wd, tag + ".fasta"),
                     "--out_prefix", pre,
                     "--stats_dir", os.path.join(REPO, "guppy5_stats"),
                     "--contig", "contig2", "--engine", "golden"]) == 0
    assert filecmp.cmp(os.path.join(wd, "gs_std.vcf.gz"), pre + ".vcf.gz",
                       shallow=False)
