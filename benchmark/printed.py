"""What the program prints that the per-layer metrics read: the realign
CLI's closing line and the ``NPORE_TIMING=1`` line of
``engine/realigner.py``."""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

_RUNTIME = re.compile(r"(\d+) reads realigned; runtime: ([\d.]+)s")
_TIMING = re.compile(
    r"\[timing\] per read: submit (\d+)us, collect-wait (\d+)us, "
    r"finalize\+emit (\d+)us, decode-wait (\d+)us, main-wait (\d+)us")
TIMING_FIELDS = ("submit", "collect_wait", "finalize_emit", "decode_wait",
                 "main_wait")

Lines = List[Tuple[float, str]]


def realign_runtime(lines: Lines) -> Optional[Tuple[int, float]]:
    """(reads written, seconds of the realign stage) of one call."""
    for _, line in lines:
        m = _RUNTIME.search(line)
        if m:
            return int(m.group(1)), float(m.group(2))
    return None


def realign_timing(lines: Lines) -> Optional[dict]:
    """The per-read µs of each stage of one call."""
    for _, line in lines:
        m = _TIMING.search(line)
        if m:
            return dict(zip(TIMING_FIELDS, map(int, m.groups())))
    return None


def timing_us_per_kb(run, field: str) -> Optional[float]:
    """A stage's µs a kb written, over the calls of the run."""
    us = 0.0
    for c in run.calls:
        rt, tm = realign_runtime(c["lines"]), realign_timing(c["lines"])
        if rt is None or tm is None:
            return None
        us += tm[field] * rt[0]
    kb = run.calls_done * run.work_per_call
    return us / kb if kb else None
