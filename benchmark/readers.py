"""Per-layer readers that more than one metric shares: the device's idle
share and the DP's roofline share, from the window's trace."""
from __future__ import annotations

from . import roofline


def device_idle_share(run):
    """The share of the window in which no kernel, copy or memset ran on
    the card (the union of the profiler's device intervals)."""
    if not run.busy_s:
        return None
    return 100 * (1 - run.busy_s / run.window_s)


def dp_roofline_share(run):
    """The least time the window's DP could take on the card
    (``roofline.py``, from the inputs alone) over all the kernel time of
    the window."""
    kernel_s = sum(run.kernel_s.values())
    if not kernel_s or not run.calls_done:
        return None
    a = run.cell["config"]["align"]
    ops, nbytes = roofline.dp_work(run.alignments, a["r"], a["max_n"])
    t, _ = roofline.least_time(ops * run.calls_done, nbytes * run.calls_done)
    return 100 * t / kernel_s
