"""The readers of the program's spans and counters: numbers on a traced
run, None on an untraced one and where the program has no tracer."""
import sys

import pytest

from benchmark import harness, spans

from .conftest import run_tiny

SPAN_METRICS = ("region_count_us_per_kb.realign",
                "decoder_busy_us_per_kb.realign",
                "sam_write_us_per_kb.realign", "h2d_bytes_per_kb.realign",
                "engine_starved_share.realign")


@pytest.fixture(scope="module")
def runs(cache):
    """A traced and an untraced run, each with the harness's Run kept."""
    kept = []

    class Kept(harness.Run):
        def __init__(self, cell):
            super().__init__(cell)
            kept.append(self)
    real, harness.Run = harness.Run, Kept
    try:
        traced = run_tiny(cache, trace=True)
        untraced = run_tiny(cache, trace=False)
    finally:
        harness.Run = real
    return {"traced": (traced, kept[0]), "untraced": (untraced, kept[1])}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_traced_run_reports_the_span_metrics(runs, name):
    (code, res), _ = runs["traced"]
    assert code == 0 and res["correct"]
    assert res["metrics"][name]["value"] > 0
    assert name == "engine_starved_share.realign" or \
        res["metrics"][name]["unit"] in ("us/kb", "B/kb")


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_untraced_run_reads_nothing(runs, name):
    (code, res), run = runs["untraced"]
    assert code == 0 and run.calls
    assert harness.load_reader(name)(run) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_the_tracer_reads_nothing(runs, name,
                                                    monkeypatch):
    _, run = runs["traced"]
    assert harness.load_reader(name)(run) is not None
    monkeypatch.setitem(sys.modules, "npore_tpu_torch.tracing", None)
    assert harness.load_reader(name)(run) is None


def test_starved_is_the_stage_less_the_groups_in_flight():
    """Groups in flight from their submit's end to their collect's end,
    overlapping, nested and running past the stage; another call's spans
    and a group never collected count for nothing."""
    from npore_tpu_torch.tracing import Span

    def sp(name, t0, t1, call=1, group=None):
        return Span(0, name, 0, t0, t1, None, call, None, group)
    got = [sp("realign.stage", 100, 1100),
           sp("engine.submit", 150, 200, group=0),     # 200-400
           sp("engine.collect", 390, 400, group=0),
           sp("engine.submit", 250, 300, group=1),     # 300-500
           sp("engine.collect", 450, 500, group=1),
           sp("engine.submit", 310, 350, group=2),     # inside group 1
           sp("engine.collect", 360, 420, group=2),
           sp("engine.submit", 800, 900, group=3),     # 900-1100 (stage)
           sp("engine.collect", 1150, 1200, group=3),
           sp("engine.submit", 950, 960, group=4),     # never collected
           sp("engine.submit", 600, 700, call=2, group=5),
           sp("engine.collect", 700, 800, call=2, group=5)]
    assert spans.starved_ns(got) == (1000, 1000 - 300 - 200)
    assert spans.starved_ns(got[1:]) == (0, 0)
