"""The k-select of the two-tier probe, in plain PyTorch (kernel K3's oracle).

What ``scripts/probe_cond.py`` checks its Pallas kernel against, written
as its numpy reference is (``probe_cond.py:67-75``): per step, a
single-tier 12-rung ``where`` ladder picks ``x[:, (k-1) % Q, :]`` for
``k = run % 23 + i % 7`` in 1..12 and the sentinel 1e9 otherwise, and the
float32 sum takes every pick below the sentinel, in step order. It holds
the tiered CUDA kernel (``csrc/tier_select.cu``) to the untiered meaning.
It runs on any device: the CPU in the tests, the card as the kernel's
reference.
"""
from __future__ import annotations

from typing import Optional

import torch

RUNGS = 12       # rungs of the full ladder
MOD_RUN = 23     # k = run % 23 + i % 7
MOD_STEP = 7
SENTINEL = 1e9


def tier_select_plain(x: torch.Tensor, n_steps: int, q: int,
                      run0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x``: (W, Qx >= q, LANES) float32; ``run0``: int32 (W, LANES)
    starting counts (zeros when None). Returns the (W, LANES) float32
    sums."""
    ct = x[:, :q, :]
    W, _, lanes = x.shape
    acc = torch.zeros(W, lanes, dtype=torch.float32, device=x.device)
    run = (torch.zeros(W, lanes, dtype=torch.int32, device=x.device)
           if run0 is None else run0.to(torch.int32))
    sentinel = torch.full_like(acc, SENTINEL)
    zero = torch.zeros_like(acc)
    for i in range(n_steps):
        k = run % MOD_RUN + i % MOD_STEP
        cv = sentinel
        for kk in range(1, RUNGS + 1):
            cv = torch.where(k == kk, ct[:, (kk - 1) % q, :], cv)
        acc = acc + torch.where(cv < SENTINEL, cv, zero)
        run = run + 1
    return acc
