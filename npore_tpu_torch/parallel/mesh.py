"""Data parallelism over several devices (the port of
``npore_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``data`` mesh over its chips and shard_maps the
window DP over it, with a ``psum`` of the edit-op histogram and of the
confusion counts. Here a mesh is an ordered tuple of devices:

* a packed group is split along its window axis into one shard a device
  (``shard_batch``), and each shard runs K1 (``ops/dp_cuda.band_dp``) on
  its device, or the plain DP for a CPU shard; the score tables
  (~0.6 MB) are copied to each device;
* the op histogram is summed over the shards, then over ranks when a
  process group is up (``distributed.allreduce_sum``);
* ``reduce_confusion_matrices`` sums per-shard confusion partials.

The sums are plain torch reductions: in the JAX package they are XLA
code, not Pallas kernels. The same device may appear more than once in a
mesh (two shards on one card), which checks the split on a machine with
one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig
from ..ops import dp_cuda
from .distributed import allreduce_sum

N_OPS = 5        # MAT, INS, LEN, DEL, SHR


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D ``data`` mesh: the devices that hold its shards, in order."""
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_data_mesh(devices=None) -> DataMesh:
    """A mesh over ``devices`` (names or torch.devices), by default every
    visible CUDA card."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_data_mesh: no CUDA card is visible; "
                               "pass the devices")
    if isinstance(devices, DataMesh):
        return devices
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return DataMesh(devs)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DataMesh
                ) -> List[Dict[str, torch.Tensor]]:
    """Split a packed group (``windows.tensor_views`` or ``pack_batch``
    arrays) along the window axis into ``mesh.size`` shards, each copied
    to its device. The window count must divide evenly by the mesh size."""
    B = int(batch["inss"].shape[0])
    if B % mesh.size:
        raise ValueError(f"{B} windows do not split evenly over a mesh of "
                         f"{mesh.size} devices")
    n = B // mesh.size
    return [{k: torch.as_tensor(v)[i * n:(i + 1) * n].to(dev, copy=True)
             for k, v in batch.items()}
            for i, dev in enumerate(mesh.devices)]


def op_counts(packed: torch.Tensor) -> torch.Tensor:
    """int64 histogram of the MAT-plane op types over live cells (run > 0)
    of packed planes ``typ | run << 3``."""
    typ = (packed & 7)[(packed >> 3) > 0]
    return torch.bincount(typ.long(), minlength=N_OPS)[:N_OPS]


def make_sharded_step(mesh: DataMesh, cfg: AlignConfig):
    """``step(shards, tables) -> (planes, op_counts)``: the banded DP of
    every shard on its device (K1 on a card, the plain DP on the CPU), as
    packed int32 planes (B / mesh.size, R, 64) a shard, and the op
    histogram summed over the shards and, under a process group, over
    ranks, as int64 (5,) on the mesh's first device."""
    def step(shards: Sequence[Dict[str, torch.Tensor]],
             tables: Dict[str, torch.Tensor]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size} devices")
        planes = []
        for shard, dev in zip(shards, mesh.devices):
            tabs = {k: v.to(dev) for k, v in tables.items()}
            planes.append(dp_cuda.band_dp(shard, tabs, cfg))
        counts = sum(op_counts(p).to(mesh.devices[0]) for p in planes)
        return planes, allreduce_sum(counts)
    return step


def reduce_confusion_matrices(mesh: DataMesh, subs, nps, inss, dels):
    """Sum stacked per-shard confusion partials (leading dimension
    ``mesh.size``, shard i on device i) over the mesh; returns int64
    numpy totals, as the JAX package's psum over its ``data`` axis."""
    out = []
    for x in (subs, nps, inss, dels):
        x = np.asarray(x)
        if x.shape[0] != mesh.size:
            raise ValueError(f"need {mesh.size} shards, got {x.shape[0]}")
        parts = [torch.from_numpy(x[i].astype(np.int64)).to(dev)
                 for i, dev in enumerate(mesh.devices)]
        total = sum(p.to(mesh.devices[0]) for p in parts)
        out.append(total.cpu().numpy())
    return tuple(out)
