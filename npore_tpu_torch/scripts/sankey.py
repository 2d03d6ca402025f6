"""Multi-stage sankey renderer (capability-equivalent, from-scratch
replacement for the pySankey derivative in reference scripts/sankey.py).

``sankey()`` draws S stages over S+1 label columns. Each stage s is a list
of parallel flows: ``lefts[s][j] -> rights[s][j]`` carrying
``leftWeights[s][j]`` out of the left stratum and ``rightWeights[s][j]``
into the right one (the two may differ — the reference uses this to show
e.g. region *sizes* flowing into error *counts*). Adjacent stages share
their middle column: rights[s] and lefts[s+1] must use the same label set.

Strata are stacked in first-appearance order; ribbon colors come from the
``colors`` dict keyed by the left label (or right label where
``rightColors[s]`` is set), matching the reference's interface
(scripts/sankey.py:sankey args; call sites scripts/plot_sankey.py:211-223,
276-287).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

BAR_W = 0.04          # stratum bar half-width in axis units
GAP = 0.015           # vertical gap between strata (fraction of column)


def _column(labels: Sequence[str], weights: Sequence[float], gap: bool):
    """Stack strata in first-appearance order; returns label -> (y0, size)
    plus per-flow cursor state for ribbon attachment."""
    order: List[str] = []
    size: Dict[str, float] = {}
    for lb, w in zip(labels, weights):
        if lb not in size:
            order.append(lb)
            size[lb] = 0.0
        size[lb] += w
    total = sum(size.values()) or 1.0
    g = GAP if gap or True else 0.0
    y = 0.0
    span: Dict[str, tuple] = {}
    for lb in order:
        h = size[lb] / total
        span[lb] = (y, h)
        y += h + g
    return span, order


def sankey(lefts: Sequence[Sequence[str]], rights: Sequence[Sequence[str]],
           colors: Dict[str, str], leftWeights: Sequence[Sequence[float]],
           rightWeights: Sequence[Sequence[float]],
           rightColors: Sequence[bool], gaps: Sequence[bool],
           bottoms: Optional[Sequence[str]] = None, fontsize: int = 12,
           figureName: str = "sankey", close: bool = True,
           figsize=(10, 6)):
    n_stages = len(lefts)
    fig, ax = plt.subplots(figsize=figsize)

    # column layouts: col 0 = lefts[0]; col s+1 = rights[s]
    cols = [_column(lefts[0], leftWeights[0], gaps[0])]
    for s in range(n_stages):
        cols.append(_column(rights[s], rightWeights[s], gaps[s]))

    for s in range(n_stages):
        lspan, _ = cols[s]
        rspan, _ = cols[s + 1]
        lofs = {lb: y for lb, (y, _h) in lspan.items()}
        rofs = {lb: y for lb, (y, _h) in rspan.items()}
        ltot = sum(w for w in leftWeights[s]) or 1.0
        rtot = sum(w for w in rightWeights[s]) or 1.0
        for j, (ll, rl) in enumerate(zip(lefts[s], rights[s])):
            lw = leftWeights[s][j] / ltot
            rw = rightWeights[s][j] / rtot
            if lw <= 0 and rw <= 0:
                continue
            y0, y1 = lofs[ll], rofs[rl]
            lofs[ll] += lw
            rofs[rl] += rw
            key = rl if rightColors[s] else ll
            color = colors.get(key, "#999999")
            xs = np.linspace(s + BAR_W, s + 1 - BAR_W, 60)
            t = (1 - np.cos(np.pi * np.linspace(0, 1, 60))) / 2
            lo = y0 + (y1 - y0) * t
            hi = (y0 + lw) + ((y1 + rw) - (y0 + lw)) * t
            ax.fill_between(xs, lo, hi, color=color, alpha=0.6, lw=0)

    # stratum bars + labels
    for ci, (span, order) in enumerate(cols):
        for lb in order:
            y, h = span[lb]
            if h <= 0:
                continue
            ax.fill_between([ci - BAR_W, ci + BAR_W], [y, y],
                            [y + h, y + h],
                            color=colors.get(lb, "#555555"), lw=0)
            side = "right" if ci == 0 else "left"
            x = ci - BAR_W - 0.02 if ci == 0 else ci + BAR_W + 0.02
            if 0 < ci < len(cols) - 1:
                x, side = ci, "center"
            ax.text(x, y + h / 2, lb, ha=side, va="center",
                    fontsize=fontsize - 2)

    if bottoms:
        for ci, text in enumerate(bottoms):
            ax.text(ci, -0.06, text, ha="center", va="top",
                    fontsize=fontsize)
    ax.set_xlim(-0.6, n_stages + 0.6)
    ax.set_ylim(-0.12, 1.0 + GAP * 8)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(f"{figureName}.png", dpi=200)
    if close:
        plt.close(fig)
    return fig
