"""Engine name -> torch.device, with no silent fallback between devices."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(engine: str,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``"cuda"`` is the kernel path and needs a card: it raises without
    one. ``"torch"`` is the plain PyTorch path and runs on ``device``
    (the CPU when none is given)."""
    if engine == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("engine 'cuda' needs a CUDA device, and "
                               "torch.cuda.is_available() is False")
        dev = torch.device(device if device is not None else "cuda")
        if dev.type != "cuda":
            raise ValueError(f"engine 'cuda' cannot run on {dev}")
        return dev
    if engine == "torch":
        return torch.device(device if device is not None else "cpu")
    raise ValueError(f"unknown device engine {engine!r} (cuda|torch)")
