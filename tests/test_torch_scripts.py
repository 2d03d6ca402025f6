"""The port's scripts against the JAX package's: ``tag_unphased``,
``plot_sankey`` (the count cases of tests/test_sankey.py on both modules,
and ``main``'s summary and figures), the shell wrappers (syntax, bare-call
checks, ``calc_beds.sh`` and ``purity.sh`` executed) and the verbatim
copies. Every comparison is exact."""
import contextlib
import glob
import io
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
PORT = os.path.join(REPO, "npore_tpu_torch", "scripts")
PORT_SHELL = ["align.sh", "calc_beds.sh", "purity.sh", "realign_pipeline.sh"]


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _run(argv):
    """Run ``argv`` from the repo root; the JAX package's CLIs on the CPU
    (the port ignores NPORE_PLATFORM)."""
    res = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                         timeout=300,
                         env=dict(os.environ, NPORE_PLATFORM="cpu"))
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return res


# --- tag_unphased ---

def _untag(data_dir, path, every):
    """reads.bam (where every read has an HP tag) with the HP tag taken off
    every ``every``-th read."""
    from npore_tpu_torch.io.bam import BamReader
    from npore_tpu_torch.io.bam_writer import write_bam
    reads = BamReader(os.path.join(data_dir, "reads.bam"))
    recs = list(reads)
    assert all(rec.has_tag("HP") for rec in recs)
    for rec in recs[::every]:
        rec.tags = {k: v for k, v in rec.tags.items() if k != "HP"}
    write_bam(path, list(reads.references), [int(n) for n in reads.lengths],
              recs)
    return path


def _split_cl(sam):
    """(the @PG line's CL split into words, the file without it)."""
    text = _bytes(sam).decode()
    pg = next(line for line in text.splitlines() if line.startswith("@PG"))
    head, cl = pg.split("\tCL:")
    return cl.split(" "), text.replace(pg, head)


@pytest.mark.parametrize("every,n_tagged", [(0, 0), (2, 5), (1, 10)],
                         ids=["all_tagged", "half_tagged", "none_tagged"])
def test_tag_unphased_equals_jax(tmp_path, data_dir, every, n_tagged):
    """On reads.bam as it is (every read has HP), with HP taken off half
    the reads, and off all of them."""
    bam = os.path.join(data_dir, "reads.bam")
    if every:
        bam = _untag(data_dir, str(tmp_path / "in.bam"), every)
    want, got = str(tmp_path / "jax.sam"), str(tmp_path / "port.sam")
    jres = _run([sys.executable, os.path.join(SCRIPTS, "tag_unphased.py"),
                 bam, want])
    tres = _run([sys.executable, "-m", "npore_tpu_torch.scripts.tag_unphased",
                 bam, got])
    # the @PG line's CL is the command line, whose program and output
    # paths differ; every other byte is the same
    got_cl, got_rest = _split_cl(got)
    want_cl, want_rest = _split_cl(want)
    assert got_rest == want_rest
    assert got_cl[1:] == [bam, got] and want_cl[1:] == [bam, want]
    assert tres.stdout == jres.stdout == f"tagged {n_tagged} unphased reads\n"
    from npore_tpu_torch.io.sam import SamReader
    recs = list(SamReader(got))
    assert len(recs) == 10 and all(r.has_tag("HP") for r in recs)


# --- plot_sankey ---

@pytest.fixture(scope="module")
def sankey_modules():
    pytest.importorskip("matplotlib")
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import plot_sankey as jax_ps
    from npore_tpu_torch.scripts import plot_sankey as port_ps
    return {"jax": jax_ps, "port": port_ps}


HDR = ("##fileformat=VCFv4.2\n"
       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tTRUTH"
       "\tQUERY\n")


def _vcf(path, lines):
    with open(path, "w") as fh:
        fh.write(HDR + "".join(lines))
    return str(path)


def rec(pos, ref, alt, bd_t, bi_t, bd_q, bi_q, gt="0/1"):
    return (f"c\t{pos + 1}\t.\t{ref}\t{alt}\t30\tPASS\t.\tGT:BD:BI\t"
            f"{gt}:{bd_t}:{bi_t}\t{gt}:{bd_q}:{bi_q}\n")


def _types_and_calls(ps, tmp_path):
    refs = {"c": "ACGTACGTAC" + "A" * 8 + "GTCGTTGCAT" * 4}
    vcf = _vcf(tmp_path / "ev.vcf", [
        rec(2, "G", "T", "TP", "ti", "TP", "ti"),
        rec(4, "A", "G", "FN", "tv", ".", "."),
        rec(6, "G", "C", ".", ".", "FP", "tv"),
        rec(9, refs["c"][9], refs["c"][9] + "A", "TP", "i1_5", "TP", "i1_5"),
        rec(20, refs["c"][20] + refs["c"][21], refs["c"][20],
            "FN", "d1_5", ".", "."),
    ])
    data = ps.count(vcf, refs)
    assert data.types[ps.SUB, ps.TP] == 1
    assert data.types[ps.SUB, ps.FN] == 1
    assert data.types[ps.SUB, ps.FP] == 1
    assert data.types[ps.INS, ps.TP] == 1
    assert data.types[ps.DEL, ps.FN] == 1
    assert data.cnvs[ps.TRUE] == 1 and data.cnvs[ps.FALSE] == 1
    return data


def _complex(ps, tmp_path):
    refs = {"c": "ACGTACGTACGTACGTACGTACGTACGTACGT"}
    vcf = _vcf(tmp_path / "ev.vcf", [
        rec(2, "G", "T,GA", "TP", "ti", "TP", "ti", gt="1/2"),
        rec(8, "A", "G", "FN", "t1,i2", ".", "."),
    ])
    data = ps.count(vcf, refs)
    assert data.types[ps.CPX, ps.TP] == 1
    assert data.types[ps.CPX, ps.FN] == 1
    assert data.types[ps.SUB].sum() == 0
    return data


def _deletion_cnv(ps, tmp_path):
    refs = {"c": "GG" + "AT" * 6 + "CCGGTTACGTACTGAC"}
    vcf = _vcf(tmp_path / "ev.vcf", [
        rec(1, "GAT", "G", "TP", "d1_5", "TP", "d1_5"),
    ])
    data = ps.count(vcf, refs)
    assert data.cnvs[ps.TRUE] == 1 and data.cnvs[ps.FALSE] == 0
    return data


def _render(ps, tmp_path):
    datas = []
    for i in range(7):
        d = ps.VcfCounts()
        d.types[ps.SUB, ps.TP] = 3 + i
        d.types[ps.INS, ps.FN] = i
        d.types[ps.DEL, ps.FP] = 1
        d.cnvs[:] = (2, i)
        datas.append(d)
    sizes = {f"np_{i}": 100 * (7 - i) for i in range(7)}
    sizes["all"] = sizes["np_all"] = sum(sizes.values())
    ps.plot_sankey(datas, sizes, str(tmp_path))
    assert os.path.exists(tmp_path / "sankey1.png")
    assert os.path.exists(tmp_path / "sankey2.png")
    return None


@pytest.mark.parametrize("module", ["jax", "port"])
@pytest.mark.parametrize("case", [_types_and_calls, _complex, _deletion_cnv,
                                  _render],
                         ids=["types_and_calls", "complex", "deletion_cnv",
                              "render"])
def test_sankey_cases(sankey_modules, tmp_path, case, module):
    """tests/test_sankey.py's cases on either module; the port's counts
    equal the JAX script's."""
    got = case(sankey_modules[module], tmp_path)
    if got is not None and module == "port":
        want = case(sankey_modules["jax"], tmp_path)
        assert np.array_equal(got.types, want.types)
        assert np.array_equal(got.cnvs, want.cnvs)
        assert str(got) == str(want)


def _happy_strata(d):
    """hap.py-style VCFs for the strata all, np_0..np_6 over a contig with
    homopolymer and dinucleotide runs, and one BED a stratum."""
    rng = np.random.default_rng(5)
    body = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    seq = body[:100] + "A" * 9 + body[100:200] + "CA" * 7 + body[200:]
    with open(os.path.join(d, "ref.fasta"), "w") as fh:
        fh.write(">c\n" + seq + "\n")
    lines = [
        rec(20, seq[20], "ACGT"[("ACGT".index(seq[20]) + 1) % 4],
            "TP", "ti", "TP", "ti"),
        rec(40, seq[40], "ACGT"[("ACGT".index(seq[40]) + 2) % 4],
            "FN", "tv", ".", "."),
        rec(60, seq[60], "ACGT"[("ACGT".index(seq[60]) + 3) % 4],
            ".", ".", "FP", "tv"),
        rec(99, seq[99], seq[99] + "A", "TP", "i1_5", "TP", "i1_5"),
        rec(99, seq[99:101], seq[99], "FN", "d1_5", ".", "."),
        rec(208, seq[208:210 + 2], seq[208], "TP", "d1_5", "TP", "d1_5"),
        rec(300, seq[300], seq[300] + "GT", "FN", "i1_5", ".", "."),
        rec(330, seq[330], "G,GA", "TP", "ti", "TP", "ti", gt="1/2"),
    ]
    for i, name in enumerate(["all"] + [f"np_{n}" for n in range(7)]):
        # every stratum holds each variant type (the pie charts divide by
        # each type's count) and its own share of repeated records
        _vcf(os.path.join(d, f"ev-{name}.vcf"),
             lines + [lines[i % len(lines)]] * i)
        with open(os.path.join(d, f"{name}.bed"), "w") as fh:
            fh.write(f"c\t{10 * i}\t{100 + 40 * i}\n")
    return os.path.join(d, "ref.fasta")


def test_plot_sankey_main_equals_jax(sankey_modules, tmp_path):
    """``main`` on hap.py-style strata: the port prints the JAX script's
    summary text and writes the same figure files, byte for byte."""
    ref = _happy_strata(str(tmp_path))
    out = {}
    for name, ps in sankey_modules.items():
        args = ps.argparser().parse_args([
            "--ref", ref, "--vcfs", str(tmp_path / "ev-$.vcf"),
            "--beds", str(tmp_path / "$.bed"),
            "--out_dir", str(tmp_path / name), "--serial"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert ps.main(args) == 0
        out[name] = buf.getvalue().replace(str(tmp_path / name), "OUT")
    assert out["port"] == out["jax"]
    assert "CNVs:" in out["port"] and "np_6: " in out["port"]
    figs = sorted(os.path.basename(p)
                  for p in glob.glob(str(tmp_path / "jax" / "*.png")))
    assert len(figs) == 18 and "sankey2.png" in figs
    assert figs == sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "port" / "*.png")))
    for f in figs:
        assert _bytes(tmp_path / "port" / f) == _bytes(tmp_path / "jax" / f), f


# --- shell wrappers and verbatim copies ---

@pytest.mark.parametrize("name", ["sankey.py", "align.sh"])
def test_verbatim_copies(name):
    assert _bytes(os.path.join(PORT, name)) == _bytes(
        os.path.join(SCRIPTS, name))


@pytest.mark.parametrize("name", PORT_SHELL)
def test_port_shell_syntax_and_mode(name):
    path = os.path.join(PORT, name)
    out = subprocess.run(["bash", "-n", path], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
    assert os.access(path, os.X_OK)


@pytest.mark.parametrize("name", PORT_SHELL)
def test_port_shell_arg_check_fails_fast(name):
    out = subprocess.run(["bash", os.path.join(PORT, name)],
                         capture_output=True, text=True, timeout=30)
    assert out.returncode != 0
    assert out.stderr.strip(), name


def test_calc_beds_sh_equals_jax(tmp_path, data_dir):
    """The port's calc_beds.sh and scripts/calc_beds.sh on one FASTA and
    BED: the same files, byte for byte."""
    ref = os.path.join(data_dir, "ref.fasta")
    bed = str(tmp_path / "genome.bed")
    with open(bed, "w") as fh:
        fh.write("ref\t0\t1000\n")
    for side, d in (("port", PORT), ("jax", SCRIPTS)):
        os.makedirs(tmp_path / side)
        _run(["bash", os.path.join(d, "calc_beds.sh"), ref, bed,
              str(tmp_path / side / "np")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert "np_all.bed" in names and "np_6.bed" in names
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert _bytes(tmp_path / "port" / n) == _bytes(tmp_path / "jax" / n)


def test_purity_sh_equals_jax(tmp_path, data_dir):
    """The port's purity.sh and scripts/purity.sh (both always --plot, so
    matplotlib is needed) on two BAMs: the same purity scores, and the
    plot written."""
    pytest.importorskip("matplotlib")
    bam = os.path.join(data_dir, "reads.bam")
    for side, d in (("port", PORT), ("jax", SCRIPTS)):
        _run(["bash", os.path.join(d, "purity.sh"), str(tmp_path / side),
              f"{bam},{bam}", "a,b"])
        assert os.path.isfile(str(tmp_path / side) + "_purity.png")
    for name in ("a", "b"):
        got = np.load(str(tmp_path / "port") + f"_{name}.npy")
        assert len(got) and np.array_equal(
            got, np.load(str(tmp_path / "jax") + f"_{name}.npy"))
