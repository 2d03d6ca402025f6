"""The port's tracer (``npore_tpu_torch/tracing.py``): nothing recorded
when ``NPORE_TIMING`` is off; on, one realign CLI call (``--engine
torch``, the fixture BAM in batches of 4 reads) records every span of the
CLI, the pipeline and the engine under one call id, nested and on the
threads the pipeline runs them on; the ``[timing]`` lines are built from
the spans; ``--profile_dir`` writes the spans into its trace. Only a call
that trains (or shards) counts the reads of each contig
(``regions.count``)."""
import json
import os
import re
import shutil
import sys
import threading

import pytest
import torch

from benchmark import printed
from npore_tpu_torch import tracing

torch.set_num_threads(2)

# span -> the span it runs under
PARENTS = {
    "realign.fasta": "realign.call",
    "realign.region_count": "realign.call",
    "realign.tables": "realign.call",
    "realign.header": "realign.call",
    "realign.stage": "realign.call",
    "realign.engine_init": "realign.stage",
    "realign.sam_write": "realign.stage",
    "pipeline.decode": "realign.stage",
    "pipeline.decode_wait": "realign.stage",
    "pipeline.main_wait": "realign.stage",
    "pipeline.stage_a": "realign.stage",
    "pipeline.stage_b": "realign.stage",
    "engine.windows": "pipeline.stage_a",
    "engine.submit": "pipeline.stage_a",
    "engine.collect": ("pipeline.stage_a", "pipeline.stage_b"),
    "engine.golden": "pipeline.stage_b",
    "pipeline.finalize": "pipeline.stage_b",
    "pipeline.sam_build": "pipeline.stage_b",
}
MAIN_THREAD = ("realign.call", "realign.fasta", "realign.region_count",
               "realign.tables", "realign.header", "realign.stage",
               "realign.engine_init", "realign.sam_write",
               "pipeline.decode_wait", "pipeline.main_wait")
BATCH = 4


@pytest.fixture(autouse=True)
def tracer_off_after(monkeypatch):
    yield
    monkeypatch.delenv("NPORE_TIMING", raising=False)
    tracing.set_from_env()
    tracing.reset()


def _argv(data_dir, stats_dir, pre, *more):
    return ["--bam", os.path.join(data_dir, "reads.bam"),
            "--ref", os.path.join(data_dir, "ref.fasta"),
            "--out_prefix", pre, "--stats_dir", stats_dir,
            "--engine", "torch", *more]


@pytest.fixture(scope="module")
def traced(tmp_path_factory, data_dir, stats_dir):
    """One traced CLI call: its spans, counters, stdout, Realigner, the
    profile directory and argv."""
    from io import StringIO
    from contextlib import redirect_stdout
    from npore_tpu_torch.cli import realign
    tmp = tmp_path_factory.mktemp("traced")
    prof = str(tmp / "prof")
    argv = _argv(data_dir, stats_dir, str(tmp / "out"), "--batch_reads",
                 str(BATCH), "--profile_dir", prof)
    os.environ["NPORE_TIMING"] = "1"
    tracing.reset()
    log = StringIO()
    try:
        with redirect_stdout(log):
            rl = realign.run(argv)
        rec = tracing.read()
    finally:
        del os.environ["NPORE_TIMING"]
        tracing.set_from_env()
        tracing.reset()
    return {"spans": rec["spans"], "counters": rec["counters"],
            "threads": rec["threads"], "stdout": log.getvalue(), "rl": rl,
            "prof": prof, "argv": argv}


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing(tmp_path, data_dir, stats_dir, monkeypatch):
    from npore_tpu_torch.cli import realign
    monkeypatch.delenv("NPORE_TIMING", raising=False)
    tracing.reset()
    rl = realign.run(_argv(data_dir, stats_dir, str(tmp_path / "o"),
                           "--max_reads", "2"))
    assert rl._engine.groups >= 1
    assert tracing.read()["spans"] == [] and tracing.read()["counters"] == {}
    assert tracing.span("a") is tracing.span("b", batch=1)
    assert tracing.context() is None
    tracing.record("a", 0, 1)
    tracing.count("a", 5)
    assert tracing.read()["spans"] == [] and tracing.read()["counters"] == {}


def test_every_span_of_the_table_in_one_call(traced):
    names = {s.name for s in traced["spans"]}
    assert names == set(PARENTS) | {"realign.call"}
    assert len({s.call for s in traced["spans"]}) == 1
    assert len(traced["spans"]) < 120       # per call, batch or group


def test_nesting(traced):
    by_id = {s.id: s for s in traced["spans"]}
    (root,) = _by_name(traced["spans"])["realign.call"]
    assert root.parent is None
    for s in traced["spans"]:
        if s is root:
            continue
        parent = by_id[s.parent]
        want = PARENTS[s.name]
        assert parent.name in (want if isinstance(want, tuple) else (want,))
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1, s.name
    # the main thread's children of the call cover nearly all of it
    kids = sum(s.t1 - s.t0 for s in traced["spans"] if s.parent == root.id)
    assert kids >= 0.95 * (root.t1 - root.t0)


def test_threads(traced):
    by = _by_name(traced["spans"])
    main = by["realign.call"][0].tid
    for name in MAIN_THREAD:
        assert {s.tid for s in by[name]} == {main}, name
    tids = {n: {s.tid for s in by[n]} for n in
            ("pipeline.decode", "pipeline.stage_a", "pipeline.stage_b")}
    assert all(len(t) == 1 for t in tids.values())
    assert len(set.union(*tids.values()) | {main}) == 4
    assert {s.tid for s in by["engine.submit"]} == tids["pipeline.stage_a"]
    assert {s.tid for s in by["pipeline.finalize"]} == \
        tids["pipeline.stage_b"]
    assert traced["threads"][main] == "MainThread"


@pytest.mark.parametrize("why", ["recalc_cms", "missing_matrix"])
def test_region_count_runs_where_the_call_trains(tmp_path, data_dir,
                                                 stats_dir, monkeypatch,
                                                 why):
    """A call that trains (``--recalc_cms``, or a stats directory that
    lacks a matrix) counts the reads of each BAM contig the FASTA holds:
    one ``regions.count`` a contig, under ``realign.region_count`` on the
    main thread. The call that loads its tables (``traced``) counts
    none."""
    from npore_tpu_torch.cli import realign
    from npore_tpu_torch.io.fasta import FastaFile
    new_stats = tmp_path / "stats"
    new_stats.mkdir()
    names = ("subs", "nps", "inss", "dels")
    for n in names if why == "recalc_cms" else names[:-1]:
        shutil.copy(os.path.join(stats_dir, f"{n}_cm.npy"), new_stats)
    more = ["--recalc_exit"] + (["--recalc_cms"] if why == "recalc_cms"
                                else [])
    monkeypatch.setenv("NPORE_TIMING", "1")
    tracing.reset()
    argv = _argv(data_dir, str(new_stats), str(tmp_path / "o"), *more)
    assert realign.run(argv) is None
    by = _by_name(tracing.read()["spans"])
    (call,), (select,) = by["realign.call"], by["realign.region_count"]
    bam = realign.open_bam(os.path.join(data_dir, "reads.bam"), prep=False)
    fa = FastaFile(os.path.join(data_dir, "ref.fasta"))
    held = [c for c in bam.references if c in fa]
    assert len(by["regions.count"]) == len(held) >= 1
    for s in by["regions.count"]:
        assert s.parent == select.id and s.tid == call.tid
        assert select.t0 <= s.t0 <= s.t1 <= select.t1
    assert sorted(os.listdir(new_stats)) == sorted(f"{n}_cm.npy"
                                                   for n in names)


def test_a_loading_call_counts_no_region(traced):
    by = _by_name(traced["spans"])
    assert len(by["realign.region_count"]) == 1
    assert "regions.count" not in by


def test_batch_ids_across_threads(traced):
    by = _by_name(traced["spans"])
    n_batches = -(-10 // BATCH)
    for name in ("pipeline.stage_a", "pipeline.stage_b",
                 "pipeline.main_wait", "realign.sam_write"):
        assert sorted(s.batch for s in by[name]) == list(range(n_batches))
    # the decoder reads once more, to find the end of the reads
    for name in ("pipeline.decode", "pipeline.decode_wait"):
        assert sorted(s.batch for s in by[name]) == \
            list(range(n_batches + 1))
    for b in range(n_batches):
        seq = [[s for s in by[n] if s.batch == b][0] for n in
               ("pipeline.decode", "pipeline.stage_a", "pipeline.stage_b",
                "realign.sam_write")]
        assert all(x.t1 <= y.t1 for x, y in zip(seq, seq[1:])), b


def test_groups_and_counters(traced):
    from benchmark import spans as bspans
    by = _by_name(traced["spans"])
    eng = traced["rl"]._engine
    assert sorted(s.group for s in by["engine.submit"]) == \
        sorted(s.group for s in by["engine.collect"]) == \
        list(range(eng.groups))
    submit = {s.group: s for s in by["engine.submit"]}
    for s in by["engine.collect"]:
        assert submit[s.group].t1 <= s.t0, s.group
    # the one counter; its value is the next test's
    assert {name for (_, name) in traced["counters"]} == {"engine.h2d_bytes"}
    (stage,) = by["realign.stage"]
    total, starved = bspans.starved_ns(traced["spans"])
    assert total == stage.t1 - stage.t0 and 0 < starved < total
    # the same clock pair as wait_s
    assert sum(s.t1 - s.t0 for s in by["engine.collect"]) / 1e9 == \
        pytest.approx(eng.wait_s, rel=1e-9, abs=1e-12)


def test_h2d_bytes_are_the_groups_prefixes(traced):
    from npore_tpu_torch.cli import realign
    from npore_tpu_torch.engine.regions import get_bam_regions
    from npore_tpu_torch.engine.windows import (build_windows, group_layout,
                                                prefix_nbytes)
    from npore_tpu_torch.io.fasta import FastaFile
    args = realign.argparser().parse_args(traced["argv"])
    cfg = realign.config_from_args(args)
    regions = get_bam_regions(cfg, FastaFile(cfg.ref),
                              realign.open_bam(cfg.bam, prep=False))
    reads = list(realign.get_read_data(
        realign.open_bam(cfg.bam, skip_flags=realign.SKIP_FLAGS), regions))
    rl = traced["rl"]
    want = 0
    for i in range(0, len(reads), BATCH):
        items, _ = rl._prep_batch(reads[i:i + BATCH])
        wins = sorted((w for k, it in enumerate(items) for w in
                       build_windows(it.ref, it.seq, it.cigar, cfg.align,
                                     aln_idx=k)), key=lambda w: w.b_rows)
        for g in rl._engine._groups(wins):
            want += prefix_nbytes(group_layout(
                len(g), max(w.b_rows for w in g), cfg.align.max_n))
    got = {name: v for (_, name), v in traced["counters"].items()}
    assert got["engine.h2d_bytes"] == want > 0


def test_stage_span_is_the_printed_runtime(traced):
    (stage,) = _by_name(traced["spans"])["realign.stage"]
    reads, runtime = printed.realign_runtime(
        [(0.0, line) for line in traced["stdout"].splitlines()])
    assert reads == 10
    assert abs((stage.t1 - stage.t0) / 1e9 - runtime) <= 0.01


def test_timing_line_is_the_spans(traced):
    lines = [(0.0, line) for line in traced["stdout"].splitlines()]
    got = printed.realign_timing(lines)
    assert got is not None
    spans = traced["spans"]
    by = _by_name(spans)
    stage_b = {s.id for s in by["pipeline.stage_b"]}
    tot = {n: sum(s.t1 - s.t0 for s in by[n]) / 1e3 for n in by}
    coll = sum(s.t1 - s.t0 for s in by["engine.collect"]
               if s.parent in stage_b) / 1e3
    want = {"submit": tot["pipeline.stage_a"], "collect_wait": coll,
            "finalize_emit": tot["pipeline.stage_b"] - coll,
            "decode_wait": tot["pipeline.decode_wait"],
            "main_wait": tot["pipeline.main_wait"]}
    for k, us in want.items():
        assert abs(got[k] - us / 10) <= 0.5 + 1e-6, k


def test_profile_dir_trace_holds_the_spans(traced):
    path = os.path.join(traced["prof"], "realign_trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "npore"]
    assert {e["name"] for e in ours} == {s.name for s in traced["spans"]}
    assert len(ours) == len(traced["spans"])
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert set(rows) == {e["tid"] for e in ours}
    assert "npore-decode" in rows.values()
    call = [e for e in ours if e["name"] == "realign.call"][0]
    for e in ours:
        assert call["ts"] - 1 <= e["ts"] <= call["ts"] + call["dur"] + 1


def test_a_second_call_has_its_own_id(tmp_path, data_dir, stats_dir,
                                      monkeypatch):
    from npore_tpu_torch.cli import realign
    monkeypatch.setenv("NPORE_TIMING", "1")
    tracing.reset()
    for k in range(2):
        realign.run(_argv(data_dir, stats_dir, str(tmp_path / f"c{k}"),
                          "--max_reads", "2"))
    roots = [s for s in tracing.read()["spans"] if s.name == "realign.call"]
    assert len(roots) == 2 and roots[0].call != roots[1].call
    for r in roots:
        own = [s for s in tracing.read()["spans"] if s.call == r.call]
        assert all(r.t0 <= s.t0 and s.t1 <= r.t1 for s in own)


def test_realign_records_alone_is_one_call(data_dir, stats_dir,
                                           score_matrices, monkeypatch,
                                           capsys):
    """Without an enclosing span the pipeline's spans share a call of
    their own, and the [timing] line is still printed."""
    from npore_tpu_torch.cli.realign import SKIP_FLAGS, open_bam
    from npore_tpu_torch.engine.realigner import Realigner
    monkeypatch.setenv("NPORE_TIMING", "1")
    sub_scores, np_scores, _, _ = score_matrices
    rl = Realigner(sub_scores, np_scores, engine="torch")
    bam = open_bam(os.path.join(data_dir, "reads.bam"),
                   skip_flags=SKIP_FLAGS)
    reads = [r for r in bam][:3]
    tracing.reset()
    out = list(rl.realign_records(iter(reads), batch_size=2))
    assert len(out) == 3
    spans = tracing.read()["spans"]
    assert len({s.call for s in spans}) == 1
    assert {s.name for s in spans} >= {"pipeline.stage_a",
                                       "pipeline.stage_b", "engine.submit"}
    assert printed.realign_timing(
        [(0.0, line) for line in capsys.readouterr().out.splitlines()])


def test_standardize_vcf_spans(tmp_path, data_dir, stats_dir, monkeypatch,
                               capsys):
    from npore_tpu_torch.cli import standardize_vcf as std
    monkeypatch.setenv("NPORE_TIMING", "1")
    tracing.reset()
    std.run(["--vcf", os.path.join(data_dir, "test_std_vcf.vcf"),
             "--ref", os.path.join(data_dir, "test_std_ref.fasta"),
             "--out_prefix", str(tmp_path / "std"), "--stats_dir",
             stats_dir, "--engine", "torch"])
    spans = tracing.read()["spans"]
    by = _by_name(spans)
    assert len({s.call for s in spans}) == 1
    root = by["std.call"][0]
    for name in std.STAGES:
        (s,) = by[f"std.{name}"]
        assert s.parent == root.id
    (real,) = by["std.realign"]
    for name in ("std.submit", "std.collect", "std.normalize"):
        assert by[name][0].parent == real.id
    assert {"engine.windows", "engine.submit", "engine.collect"} <= set(by)
    out = capsys.readouterr().out
    assert re.search(r"\[timing\] window-build\+submit [\d.]+s "
                     r"\(device-wait [\d.]+s of it\)  device-wait\+decode "
                     r"[\d.]+s  normalize [\d.]+s", out)
    split = re.search(r"\[timing\] (split_vcf.*)", out).group(1)
    assert [p.split()[0] for p in split.split("  ")] == list(std.STAGES)
    for part in split.split("  "):
        name, sec = part.split()
        (s,) = by[f"std.{name}"]
        assert abs(float(sec[:-1]) - (s.t1 - s.t0) / 1e9) <= 0.005 + 1e-9


def test_spans_nest_across_threads(monkeypatch):
    monkeypatch.setenv("NPORE_TIMING", "1")
    assert tracing.set_from_env()
    tracing.reset()
    with tracing.span("outer") as outer:
        ctx = tracing.context()
        assert ctx == outer.context

        def work():
            with tracing.span("inner", batch=3, parent=ctx):
                with tracing.span("leaf", group=7):
                    tracing.count("n", 2)
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    with tracing.span("other"):
        pass
    by = _by_name(tracing.read()["spans"])
    (o,), (i,), (leaf,), (other,) = (by["outer"], by["inner"], by["leaf"],
                                     by["other"])
    assert i.parent == o.id and leaf.parent == i.id and o.parent is None
    assert i.call == leaf.call == o.call != other.call
    assert i.tid == leaf.tid != o.tid
    assert (i.batch, leaf.group) == (3, 7)
    assert tracing.read()["counters"] == {(o.call, "n"): 2}
    tracing.reset()
    assert tracing.read()["spans"] == []


def test_counters_lose_no_update_under_threads(monkeypatch):
    """More threads than cores, a short switch interval: every count and
    span of every thread is kept."""
    monkeypatch.setenv("NPORE_TIMING", "1")
    tracing.set_from_env()
    tracing.reset()
    n_threads, n = 4 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.span("root"):
            ctx = tracing.context()

            def work(k):
                for _ in range(n):
                    tracing.count("hits", 1, parent=ctx)
                with tracing.span("w", batch=k, parent=ctx):
                    pass
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rec = tracing.read()
    assert rec["counters"] == {(ctx.call, "hits"): n_threads * n}
    assert sorted(s.batch for s in rec["spans"] if s.name == "w") == \
        list(range(n_threads))
