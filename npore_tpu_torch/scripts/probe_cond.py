"""Probe: the two-tier k-select (kernel K3) on the card, against its plain
version (the port of ``scripts/probe_cond.py``).

    python -m npore_tpu_torch.scripts.probe_cond [--device cpu]

Builds the probe's input (``arange % 97`` over (32, 16, 128)), runs the
k-select for 256 steps through ``ops/tier_select_cuda`` (the CUDA kernel on
the card; the plain version on the CPU), checks it bit for bit against the
plain version, and prints ``ok=`` and the time. Raises on a mismatch. Runs
on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..ops.tier_select import tier_select_plain
from ..ops.tier_select_cuda import tier_select

W, LANES, Q, N = 32, 128, 16, 256


def probe_input(device) -> torch.Tensor:
    """The probe's x: ``arange(W * Q * LANES) % 97`` as (W, Q, LANES) f32."""
    x = torch.arange(W * Q * LANES, dtype=torch.float32).reshape(W, Q, LANES)
    return (x % 97).to(device)


def main(device: str = "cuda") -> bool:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probe runs on the card unless --device cpu "
                           "is given, and torch.cuda.is_available() is False")
    x = probe_input(dev)
    t0 = time.perf_counter()
    out = tier_select(x, N, Q)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    want = tier_select_plain(x, N, Q)
    ok = torch.equal(out, want)
    print(f"device={dev.type} ok={ok} build+run={t1 - t0:.3f}s")
    if not ok:
        raise AssertionError((out[0, :8].tolist(), want[0, :8].tolist()))
    return ok


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(p.parse_args().device)
