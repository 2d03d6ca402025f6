"""The port's copies of the host modules (npore_tpu_torch/{config,
constants,native,io,golden,model,engine/regions,engine/stats,
ops/npinfo_host,testing/synth}, io/vcf and golden/debug included) give bit-identical outputs to their
``npore_tpu`` originals on the same seeded inputs. Each side gets its own
package's objects (configs, records); only numpy arrays and strings cross.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

import npore_tpu.config as jcfg
import npore_tpu.constants as jconst
import npore_tpu.golden.debug as jdbg
import npore_tpu.golden.npinfo as jgnp
import npore_tpu.io.bam as jbam
import npore_tpu.io.bam_writer as jbw
import npore_tpu.io.cigar as jcig
import npore_tpu.io.fasta as jfa
import npore_tpu.io.sam as jsam
import npore_tpu.io.vcf as jvcf
import npore_tpu.model.scores as jsc
import npore_tpu.native as jnat
import npore_tpu.ops.npinfo_host as jnph
from npore_tpu.engine import regions as jreg
from npore_tpu.engine import stats as jstats
from npore_tpu.golden.align import align as j_align
from npore_tpu.golden.align import get_breaks as j_breaks
import npore_tpu_torch.config as tcfg
import npore_tpu_torch.constants as tconst
import npore_tpu_torch.golden.debug as tdbg
import npore_tpu_torch.golden.npinfo as tgnp
import npore_tpu_torch.io.bam as tbam
import npore_tpu_torch.io.bam_writer as tbw
import npore_tpu_torch.io.cigar as tcig
import npore_tpu_torch.io.fasta as tfa
import npore_tpu_torch.io.sam as tsam
import npore_tpu_torch.io.vcf as tvcf
import npore_tpu_torch.model.scores as tsc
import npore_tpu_torch.native as tnat
import npore_tpu_torch.ops.npinfo_host as tnph
from npore_tpu_torch.engine import regions as treg
from npore_tpu_torch.engine import stats as tstats
from npore_tpu_torch.golden.align import align as t_align
from npore_tpu_torch.golden.align import get_breaks as t_breaks
from npore_tpu_torch.testing import synth

import generate_data

REC_FIELDS = ("qname", "flag", "rname", "pos", "mapq", "cigar", "rnext",
              "pnext", "tlen", "seq", "qual", "tags")


def _seqs(seed=5, n=8):
    """Seeded int-coded sequences, half of them rich in short repeats."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2:
            unit = rng.integers(0, 4, int(rng.integers(1, 7)))
            s = np.concatenate([np.tile(unit, int(rng.integers(2, 40))),
                                rng.integers(0, 4, 30)])
        else:
            s = rng.integers(0, 4, int(rng.integers(50, 400)))
        out.append(s.astype(np.uint8))
    return out


def load_native_libs(cache: str) -> None:
    """Load both packages' C++ libraries. The JAX package's build writes
    ``libnpore_native.so`` in place in a cache shared by every test worker,
    so a worker can load the file while another still writes it; the load
    fails, the failure latches and that worker's ``get_lib()`` stays None.
    Then the library is built anew in ``cache``, this worker's own, and
    loaded; the port's library (built to a temporary name and renamed) is
    loaded again too if it failed."""
    if jnat.get_lib() is None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("NPORE_NATIVE_CACHE", cache)
            jnat._lib, jnat._tried = None, False
            jnat.get_lib()
    if tnat.get_lib() is None:
        tnat._lib, tnat._tried = None, False
        tnat.get_lib()


@pytest.fixture(scope="module", autouse=True)
def native_libs(tmp_path_factory):
    """Both C++ libraries, loaded before any test of this file: the
    comparisons reach them directly and through the readers and writers."""
    load_native_libs(str(tmp_path_factory.mktemp("npore_native")))
    assert tnat.get_lib() is not None and jnat.get_lib() is not None


def test_native_libs_recover_from_a_half_written_library(tmp_path,
                                                         monkeypatch):
    """A JAX library cut short in its cache, as a worker finds it while
    another writes it, fails to load and stays failed; load_native_libs
    builds it anew in a cache of its own and loads it."""
    with open(jnat._build(), "rb") as fh:
        head = fh.read(256)
    cache = tmp_path / "shared"
    cache.mkdir()
    (cache / "libnpore_native.so").write_bytes(head)
    monkeypatch.setenv("NPORE_NATIVE_CACHE", str(cache))
    monkeypatch.setattr(jnat, "_lib", None)
    monkeypatch.setattr(jnat, "_tried", False)
    assert jnat.get_lib() is None and jnat.get_lib() is None
    load_native_libs(str(tmp_path / "own"))
    lib = jnat.get_lib()
    assert lib is not None and lib._name == str(tmp_path / "own" /
                                                 "libnpore_native.so")
    assert np.array_equal(jnat.np_info(_seqs()[1], 6),
                          jnph.get_np_info_vec(_seqs()[1], 6))


@pytest.fixture(scope="module")
def fixture_reads(data_dir):
    path = os.path.join(data_dir, "reads.bam")
    return (list(jbam.open_alignment_file(path)),
            list(tbam.open_alignment_file(path)))


def _rec(r):
    return tuple(getattr(r, f) for f in REC_FIELDS)


def test_native_libraries_are_separate():
    """Both packages load a C++ library, from different files; the port's
    lies in its build directory."""
    from npore_tpu_torch.ops._build import build_dir
    assert tnat.get_lib() is not None and jnat.get_lib() is not None
    assert os.path.dirname(tnat.lib_path) == build_dir()
    assert tnat.lib_path != jnat._build()
    assert not hasattr(tnat, "fill_group_native")


@pytest.mark.parametrize("impl", ["native", "numpy", "golden"])
@pytest.mark.parametrize("max_n", [1, 2, 3, 4, 5, 6])
def test_np_info_equal(impl, max_n):
    fn = {"native": (tnat.np_info, jnat.np_info),
          "numpy": (tnph.get_np_info_vec, jnph.get_np_info_vec),
          "golden": (tgnp.get_np_info, jgnp.get_np_info)}[impl]
    for s in _seqs(seed=max_n):
        got, want = fn[0](s, max_n), fn[1](s, max_n)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_path_inss_and_bases_equal(fixture_reads):
    for r in fixture_reads[1]:
        ref, seq, cig = r.aln
        assert np.array_equal(tnat.path_inss_native(cig),
                              jnat.path_inss_native(cig))
        s = r.query_alignment_sequence.upper()
        assert np.array_equal(tconst.bases_to_int(s), jconst.bases_to_int(s))
        assert tconst.int_to_bases(seq) == jconst.int_to_bases(seq)


@pytest.mark.parametrize("fn", ["expand_cigar", "collapse_cigar",
                                "finalize_cigar", "finalize_cigar_batch",
                                "normalize_cigar"])
def test_cigar_functions_equal(fixture_reads, fn):
    jr, tr = fixture_reads
    items = [r.aln for r in tr]     # (int ref, int seq, expanded CIGAR)
    if fn == "expand_cigar":
        for r in tr:
            assert tcig.expand_cigar(r.cigar) == jcig.expand_cigar(r.cigar)
    elif fn == "collapse_cigar":
        for _, _, cig in items:
            assert tcig.collapse_cigar(cig) == jcig.collapse_cigar(cig)
            assert (tcig.collapse_cigar(cig, return_groups=True)
                    == jcig.collapse_cigar(cig, return_groups=True))
    elif fn == "finalize_cigar":
        for ref, seq, cig in items:
            assert (tcig.finalize_cigar(cig, ref, seq)
                    == jcig.finalize_cigar(cig, ref, seq))
    elif fn == "finalize_cigar_batch":
        args = ([c for _, _, c in items], [a[0] for a in items],
                [a[1] for a in items])
        got = tnat.finalize_cigar_batch(*args)
        assert got is not None and got == jnat.finalize_cigar_batch(*args)
    else:
        for ref, seq, cig in items:
            assert (tcig.normalize_cigar(cig, ref, seq)
                    == jcig.normalize_cigar(cig, ref, seq))


@pytest.mark.parametrize("impl", ["python", "native"])
@pytest.mark.parametrize("r", [30, 10])
def test_golden_align_equal(fixture_reads, score_matrices, impl, r):
    sub_scores, np_scores, _, _ = score_matrices
    tc, jc = tcfg.AlignConfig(r=r), jcfg.AlignConfig(r=r)
    # the python spec takes about a second a read at r=30: two reads there
    reads = fixture_reads[1][:2 if r == 30 else 4] if impl == "python" \
        else fixture_reads[1]
    for rd in reads:
        ref, seq, cig = rd.aln
        if impl == "python":
            te, je = [], []
            got = t_align(ref, seq, cig, sub_scores, np_scores, tc, te)
            want = j_align(ref, seq, cig, sub_scores, np_scores, jc, je)
            assert te == je
        else:
            got = tnat.golden_align_native(ref, seq, cig, sub_scores,
                                           np_scores, tc)
            want = jnat.golden_align_native(ref, seq, cig, sub_scores,
                                            np_scores, jc)
        assert got == want and len(got) > 0


def test_get_breaks_equal(fixture_reads):
    for r in fixture_reads[1]:
        ref, seq, cig = r.aln
        inss = tnat.path_inss_native(cig)
        dels = np.arange(len(inss)) - inss
        size = len(seq) + len(ref) + 1
        for rows in (20, 64, 20000):
            assert (t_breaks(rows, size, inss, dels)
                    == j_breaks(rows, size, inss, dels))


@pytest.mark.parametrize("reader", ["native", "python", "sam"])
def test_reader_records_equal(data_dir, reader):
    """Every field of every record, and the native prep arrays."""
    if reader == "sam":
        path = os.path.join(data_dir, "npore_realigned.sam")
        got, want = (list(tsam.SamReader(path)),
                     list(jsam.SamReader(path)))
    else:
        path = os.path.join(data_dir, "reads.bam")
        if reader == "native":
            t, j = tbam.open_alignment_file(path), jbam.open_alignment_file(
                path)
            assert type(t).__module__ == "npore_tpu_torch.io.bam_native"
            assert type(j).__module__ == "npore_tpu.io.bam_native"
        else:
            t, j = tbam.BamReader(path), jbam.BamReader(path)
        got, want = list(t), list(j)
        assert (t.references, t.lengths) == (j.references, j.lengths)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _rec(g) == _rec(w)
        if "MD" in w.tags:
            assert g.get_reference_sequence() == w.get_reference_sequence()
        assert g.query_alignment_sequence == w.query_alignment_sequence
        assert (g.query_alignment_qualities_str
                == w.query_alignment_qualities_str)
        assert g.reference_end == w.reference_end
        if reader == "native":
            assert g.aln is not None and len(g.aln) == len(w.aln) == 3
            for a, b in zip(g.aln[:2], w.aln[:2]):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            assert g.aln[2] == w.aln[2]


def test_region_fetch_equal(data_dir):
    path = os.path.join(data_dir, "reads.bam")
    t, j = tbam.open_alignment_file(path), jbam.open_alignment_file(path)
    for start, stop in ((0, 200), (300, 700), (900, 999)):
        assert ([_rec(r) for r in t.fetch("ref", start, stop)]
                == [_rec(r) for r in j.fetch("ref", start, stop)])
        assert t.count("ref", start, stop) == j.count("ref", start, stop)


def test_sam_header_and_lines_equal(fixture_reads):
    jr, tr = fixture_reads
    assert (tsam.make_header(["ref", "chr2"], [1000, 5], "0.1.0", cl="x")
            == jsam.make_header(["ref", "chr2"], [1000, 5], "0.1.0",
                                cl="x"))
    for g, w in zip(tr, jr):
        line = w.to_line()
        assert g.to_line() == line
        assert _rec(tsam.parse_sam_line(line)) == _rec(
            jsam.parse_sam_line(line))


def test_fasta_equal(data_dir):
    path = os.path.join(data_dir, "ref.fasta")
    t, j = tfa.FastaFile(path), jfa.FastaFile(path)
    assert (t.references, t.lengths) == (j.references, j.lengths)
    assert t.fetch("ref") == j.fetch("ref")
    assert t.fetch("ref", 10, 333) == j.fetch("ref", 10, 333)


def test_score_matrices_equal(stats_dir):
    cms = tsc.load_confusion_matrices(stats_dir)
    for a, b in zip(cms, jsc.load_confusion_matrices(stats_dir)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for max_n, max_l in ((6, 100), (4, 60)):
        got = tsc.calc_score_matrices(*cms, max_n, max_l)
        want = jsc.calc_score_matrices(*cms, max_n, max_l)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _run_cfgs(data_dir, **kw):
    common = dict(bam=os.path.join(data_dir, "reads.bam"),
                  ref=os.path.join(data_dir, "ref.fasta"), **kw)
    return tcfg.RealignConfig(**common), jcfg.RealignConfig(**common)


@pytest.mark.parametrize("mode", ["all", "contig", "contigs"])
def test_bam_regions_equal(data_dir, mode):
    kw = {"all": {}, "contig": {"contig": "ref", "contig_beg": 100,
                                "contig_end": 800},
          "contigs": {"contigs": "ref"}}[mode]
    tc, jc = _run_cfgs(data_dir, **kw)
    t = treg.get_bam_regions(tc, tfa.FastaFile(tc.ref),
                             tbam.open_alignment_file(tc.bam))
    j = jreg.get_bam_regions(jc, jfa.FastaFile(jc.ref),
                             jbam.open_alignment_file(jc.bam))
    assert t == j and len(t) > 0
    assert treg.get_ranges(t, 150) == jreg.get_ranges(j, 150)


def test_confusion_matrices_equal(data_dir):
    tc, jc = _run_cfgs(data_dir, chunk_width=400)
    fa_t, fa_j = tfa.FastaFile(tc.ref), jfa.FastaFile(jc.ref)
    regions = jreg.get_bam_regions(jc, fa_j, jbam.open_alignment_file(jc.bam))
    got = tstats.calc_confusion_matrices_bam(tc.bam, fa_t, regions, tc,
                                             processes=1)
    want = jstats.calc_confusion_matrices_bam(jc.bam, fa_j, regions, jc,
                                              processes=1)
    assert sum(int(a.sum()) for a in want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_config_fields_equal():
    """Same fields and defaults, apart from the JAX platform hook."""
    for name in ("AlignConfig", "RealignConfig"):
        t, j = getattr(tcfg, name)(), getattr(jcfg, name)()
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        if name == "RealignConfig":
            tf["align"], jf["align"] = (dataclasses.asdict(tf["align"]),
                                        dataclasses.asdict(jf["align"]))
        assert tf == jf
    assert tcfg.AlignConfig().band_width == jcfg.AlignConfig().band_width
    assert not hasattr(tcfg, "apply_platform_env")


def test_write_bam_equal_and_reads_back(tmp_path, fixture_reads):
    jr, tr = fixture_reads
    t_path, j_path = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    tbw.write_bam(t_path, ["ref"], [1000], tr)
    jbw.write_bam(j_path, ["ref"], [1000], jr)
    with open(t_path, "rb") as a, open(j_path, "rb") as b:
        assert a.read() == b.read()
    back = list(tbam.open_alignment_file(t_path))
    assert [_rec(r) for r in back] == [_rec(r) for r in tr]


def test_synth_equals_generate_data():
    """The port's generator functions give the test generator's reads from
    the same default_rng(7) stream (chip_smoke's mixed set)."""
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    ref_a, ref_b = synth.make_ref(a, 6000), generate_data.make_ref(b, 6000)
    assert ref_a == ref_b
    for lo, hi in ((120, 170), (260, 350), (430, 690), (950, 1400)):
        for _ in range(4):
            got = synth.make_read(a, ref_a, min_len=lo, max_len=hi)
            want = generate_data.make_read(b, ref_b, min_len=lo, max_len=hi)
            assert got == want
            assert (synth.md_tag(ref_a, got[0], got[2])
                    == generate_data.md_tag(ref_b, want[0], want[2]))
            assert int(a.integers(0, 3)) == int(b.integers(0, 3))


def test_synth_genome_equals_genome_scale():
    """The port's whole-contig generator draws the contig of
    scripts/genome_scale.py (loaded by file path) from the same seed."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "genome_scale.py")
    spec = importlib.util.spec_from_file_location("genome_scale", path)
    gs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gs)
    for seed, n in ((11, 20000), (12, 4321)):
        got = synth.make_genome(np.random.default_rng(seed), n)
        assert got == gs.make_genome(np.random.default_rng(seed), n)
        genome, runs = synth.genome_with_runs(np.random.default_rng(seed), n)
        assert genome == got and len(runs) > n // 300
        for s, p, reps in runs[:-1]:         # the last may be cut short
            run = genome[s:s + p * reps]
            assert run == run[:p] * reps


def test_truth_variants_are_phased_and_disjoint():
    rng = np.random.default_rng(8)
    genome, runs = synth.genome_with_runs(rng, 200_000)
    recs = synth.truth_variants(rng, "c", genome, runs)
    indels = [r for r in recs if len(r.alleles[0]) != len(r.alleles[1])]
    assert 150 <= len(recs) <= 200 and 20 <= len(indels) <= 40
    assert all(r.sample in ("1|0", "0|1", "1|1") for r in recs)
    assert all(a.stop <= b.pos for a, b in zip(recs, recs[1:]))
    for r in recs:
        ref, alt = r.alleles
        assert genome[r.pos:r.stop] == ref
        if r in indels:          # whole units of a run, after an anchor
            assert alt[0] == ref[0] and 1 <= abs(len(ref) - len(alt)) <= 6
        else:
            assert len(ref) == len(alt) == 1 and ref != alt


@pytest.fixture(scope="module")
def vcf_inputs(tmp_path_factory, data_dir):
    """The standardize fixture and a seeded truth set, as both packages'
    writers write them (their bytes must agree)."""
    d = tmp_path_factory.mktemp("vcf")
    rng = np.random.default_rng(9)
    genome, runs = synth.genome_with_runs(rng, 30_000)
    recs = synth.truth_variants(rng, "ctg", genome, runs, per_kb=3)
    head = tvcf.make_header([("ctg", len(genome))])
    assert head == jvcf.make_header([("ctg", len(genome))])
    seeded = str(d / "seeded.vcf.gz")
    tvcf.write_vcf(seeded, head, recs)
    jvcf.write_vcf(str(d / "jseeded.vcf.gz"), head,
                   [jvcf.parse_vcf_line(r.to_line()) for r in recs])
    for suffix in ("", ".tbi"):
        with open(seeded + suffix, "rb") as a, \
                open(str(d / "jseeded.vcf.gz") + suffix, "rb") as b:
            assert a.read() == b.read()
    return {"fixture": (os.path.join(data_dir, "test_std_vcf.vcf"),
                        [("chr18", 0, 31), ("chr19", 0, 31)],
                        os.path.join(data_dir, "test_std_ref.fasta")),
            "seeded": (seeded, [("ctg", 0, len(genome) - 1)], genome)}


def _files_equal(a, b):
    for suffix in ("", ".tbi") if a.endswith(".gz") else ("",):
        with open(a + suffix, "rb") as fa, open(b + suffix, "rb") as fb:
            assert fa.read() == fb.read(), a + suffix


@pytest.mark.parametrize("name", ["fixture", "seeded"])
@pytest.mark.parametrize("fn", ["filter_overlaps", "filter_gt", "split_vcf",
                                "merge_vcfs", "apply_vcf", "gen_vcf"])
def test_vcf_tools_equal(tmp_path, vcf_inputs, fn, name):
    vcf, regions, ref = vcf_inputs[name]
    get_ref = (lambda ctg: ref) if name == "seeded" else (
        lambda ctg: tfa.FastaFile(ref).fetch(ctg).upper())
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    assert [r.to_line() for r in tvcf.VcfReader(vcf)] == [
        r.to_line() for r in jvcf.VcfReader(vcf)]
    if fn in ("filter_overlaps", "filter_gt"):
        for suffix in (".vcf", ".vcf.gz"):
            args = ("1|0",) if fn == "filter_gt" else ()
            got = getattr(tvcf, fn)(vcf, t + suffix, *args)
            assert got == getattr(jvcf, fn)(vcf, j + suffix, *args)
            _files_equal(t + suffix, j + suffix)
        return
    t1, t2 = tvcf.split_vcf(vcf, regions, t)
    j1, j2 = jvcf.split_vcf(vcf, regions, j)
    _files_equal(t1, j1)
    _files_equal(t2, j2)
    if fn == "merge_vcfs":
        for suffix in (".vcf", ".vcf.gz"):
            tvcf.merge_vcfs(t1, t2, t + "m" + suffix, regions)
            jvcf.merge_vcfs(j1, j2, j + "m" + suffix, regions)
            _files_equal(t + "m" + suffix, j + "m" + suffix)
        return
    if fn == "split_vcf":
        return
    haps = [tvcf.apply_vcf(t1, 1, regions, get_ref),
            tvcf.apply_vcf(t2, 2, regions, get_ref)]
    assert haps == [jvcf.apply_vcf(j1, 1, regions, get_ref),
                    jvcf.apply_vcf(j2, 2, regions, get_ref)]
    assert any(len(h[2]) != len(h[3]) for hap in haps for h in hap)
    if fn == "gen_vcf":
        for hap, data in enumerate(haps, 1):
            _files_equal(tvcf.gen_vcf(data, hap, t + "g"),
                         jvcf.gen_vcf(data, hap, j + "g"))


def test_debug_printers_equal(fixture_reads, score_matrices):
    sub_scores, np_scores, _, _ = score_matrices
    for r in fixture_reads[1][:3]:
        ref, seq, cig = r.aln
        new = tnat.golden_align_native(ref, seq, cig, sub_scores, np_scores,
                                       tcfg.AlignConfig())
        for c in (cig.replace("M", "="), new):
            args = (tconst.int_to_bases(ref), tconst.int_to_bases(seq), c)
            assert tdbg.render_alignment(*args) == jdbg.render_alignment(
                *args)
            assert tdbg.render_alignment(*args, width=50) == \
                jdbg.render_alignment(*args, width=50)
    for max_n in (3, 6):
        for s in _seqs(seed=20 + max_n, n=4):
            got = tdbg.format_np_info(s, max_n)
            assert got == jdbg.format_np_info(s, max_n) and "l_idx" in got
    with pytest.raises(ValueError):
        tdbg.render_alignment("AC", "AC", "=Q")
