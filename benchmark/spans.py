"""The program's own spans and counters (``npore_tpu_torch.tracing``,
on while the traced window runs with ``NPORE_TIMING=1``) that fall in a
run's window, and sums of them a kb written. Nothing where the program
has no tracer or recorded nothing in the window."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def in_window(run) -> Optional[Tuple[List, Dict[str, int]]]:
    """The spans and the counters (summed by name) of the calls whose
    ``realign.call`` lies in the window, from the first call's start to
    the last call's end (``perf_counter``, the tracer's clock)."""
    try:
        import npore_tpu_torch.tracing as tracing
    except ImportError:
        return None
    if not run.calls:
        return None
    rec = tracing.read()
    t0, t1 = run.calls[0]["t0"] * 1e9, run.calls[-1]["t1"] * 1e9
    calls = {s.call for s in rec["spans"] if s.name == "realign.call"
             and t0 <= s.t0 and s.t1 <= t1}
    if not calls:
        return None
    counters: Dict[str, int] = {}
    for (call, name), v in rec["counters"].items():
        if call in calls:
            counters[name] = counters.get(name, 0) + v
    return [s for s in rec["spans"] if s.call in calls], counters


def span_s(spans, name: str) -> float:
    """Seconds of the spans called ``name``."""
    return sum(s.t1 - s.t0 for s in spans if s.name == name) / 1e9


def kb_written(run) -> float:
    return run.calls_done * run.work_per_call


def span_us_per_kb(run, name: str) -> Optional[float]:
    """µs of the window's spans called ``name`` a kb written."""
    got, kb = in_window(run), kb_written(run)
    if got is None or not kb:
        return None
    return 1e6 * span_s(got[0], name) / kb


def starved_ns(spans) -> Tuple[int, int]:
    """(ns of the ``realign.stage`` spans, ns of them in which the engine
    had no group in flight). A group is in flight from the end of its
    ``engine.submit`` span to the end of its ``engine.collect`` span, the
    two matched by call and group index."""
    stage = starved = 0
    for st in spans:
        if st.name != "realign.stage":
            continue
        own = [s for s in spans if s.call == st.call]
        sub = {s.group: s.t1 for s in own if s.name == "engine.submit"}
        col = {s.group: s.t1 for s in own if s.name == "engine.collect"}
        busy, end = 0, st.t0
        for a, b in sorted((max(sub[g], end), min(col[g], st.t1))
                           for g in sub if g in col):
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
        stage += st.t1 - st.t0
        starved += st.t1 - st.t0 - busy
    return stage, starved
