"""Multi-host execution on torch.distributed (the port of
``npore_tpu/parallel/distributed.py``).

The reference parallelizes within one host via ``mp.Pool`` (reference:
src/realign.py:110-114). Past one process, every rank runs the same CLI
with ``--num_hosts/--host_id/--coordinator``:

* ``init_distributed`` starts one process group over a TCP store at the
  coordinator, on **gloo**: the work the ranks share is host data (the
  confusion counts, a barrier), so the default group is a CPU group;
* work is sharded deterministically by region (``shard_regions``), or by
  read stripes when ranks outnumber regions (``stripe_reads``), so ranks
  never exchange reads;
* confusion-count training sums each rank's counts exactly with an int64
  ``all_reduce`` (``allreduce_counts``);
* each rank writes ``{out_prefix}.h{i}.sam``; after a barrier, rank 0
  merges them coordinate-sorted (``merge_host_sams``).

Each rank drives one card, ``cuda:(LOCAL_RANK mod device_count)``
(``rank_device``). With ``backend="nccl"`` a second group on **NCCL**
carries device tensors (``allreduce_sum`` of a CUDA tensor); NCCL refuses
two ranks on one card, so that request raises when the rank -> device map
has a duplicate, rather than switching backend. Barriers always run on
gloo. Single-process runs take none of these paths (``num_hosts == 1`` is
a no-op), and the host functions below are copies of the JAX package's.
"""
from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
TIMEOUT = timedelta(minutes=30)     # ranks may build kernels at different
                                    # speeds before their first collective
_nccl_group = None                  # the NCCL group of backend="nccl"


def init_distributed(coordinator: Optional[str] = None,
                     num_hosts: int = 1,
                     host_id: Optional[int] = None,
                     backend: str = "gloo") -> Tuple[int, int]:
    """Join the process group; returns (host_id, num_hosts).

    No-op for ``num_hosts == 1``. torchrun's environment stands in for the
    flags, as the JAX launcher's variables do for the JAX package:
    ``MASTER_ADDR``/``MASTER_PORT`` for ``coordinator``, ``WORLD_SIZE``
    for ``num_hosts`` and ``RANK`` for ``host_id``."""
    if coordinator is None and os.environ.get("MASTER_ADDR") and \
            os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_hosts == 1 and os.environ.get("WORLD_SIZE"):
        num_hosts = int(os.environ["WORLD_SIZE"])
    if host_id is None:
        host_id = int(os.environ.get("RANK", "0"))
    if num_hosts <= 1:
        return 0, 1
    if coordinator is None:
        raise ValueError("--coordinator (or MASTER_ADDR and MASTER_PORT) is "
                         "required for multi-host runs")
    return start_group(coordinator, num_hosts, host_id, backend)


def start_group(coordinator: str, size: int, rank: int,
                backend: str = "gloo") -> Tuple[int, int]:
    """Start the gloo process group over ``tcp://coordinator`` (any world
    size, 1 included) and, for ``backend="nccl"``, an NCCL group over the
    same ranks. Prints the rank -> device map on rank 0."""
    global _nccl_group
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=size, rank=rank, timeout=TIMEOUT)
    here = rank_device()
    ranks = [None] * size
    dist.all_gather_object(ranks, (socket.gethostname(), str(here)))
    if backend == "nccl":
        try:
            check_nccl_map(ranks)
        except RuntimeError:
            shutdown()
            raise
        torch.cuda.set_device(here)
        _nccl_group = dist.new_group(backend="nccl")
    if rank == 0:
        table = ", ".join(f"{r}->{h}:{d}" for r, (h, d) in enumerate(ranks))
        print(f"[dist] {size} ranks, host data on gloo, device tensors on "
              f"{backend}; rank->device {table}", flush=True)
    # warm the group now, while every rank is at the same point: the JAX
    # package saw gloo's lazily built context time out when one host was
    # still compiling kernels at the first collective
    barrier("npore-init")
    return rank, size


def check_nccl_map(ranks: Sequence[Tuple[str, str]]) -> None:
    """Raise unless every rank of the (host, device) map has a card of
    its own: NCCL refuses two ranks on one card ("Duplicate GPU")."""
    seen = {}
    for r, where in enumerate(ranks):
        if not where[1].startswith("cuda"):
            raise RuntimeError(f"backend 'nccl': rank {r} has no CUDA card "
                               f"({where[0]}:{where[1]})")
        if tuple(where) in seen:
            raise RuntimeError(
                f"backend 'nccl': ranks {seen[tuple(where)]} and {r} share "
                f"{where[0]}:{where[1]}, and NCCL refuses two ranks on one "
                "card; run them on gloo, or give each its own card")
        seen[tuple(where)] = r


def shutdown() -> None:
    """Leave the process group (no-op when none is up)."""
    global _nccl_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _nccl_group = None


def local_rank() -> int:
    """``LOCAL_RANK`` (torchrun's), else the global rank: ranks started
    by hand with ``--host_id`` on one machine count from 0 there."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device() -> torch.device:
    """The card this rank drives, ``cuda:(LOCAL_RANK mod count)``, or the
    CPU on a machine without one."""
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank() % n) if n else \
        torch.device("cpu")


def local_devices() -> List[torch.device]:
    """The cards this process drives: under a process group the rank's
    one card, otherwise every visible card."""
    if dist.is_initialized():
        dev = rank_device()
        return [dev] if dev.type == "cuda" else []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_regions(regions: Sequence[Tuple[str, int, int]], num_hosts: int,
                  host_id: int) -> List[Tuple[str, int, int]]:
    """Deterministic round-robin region shard for one host.

    Regions are already chunked (engine/regions.get_bam_regions), so a
    round-robin over the sorted list load-balances long contigs across
    hosts without communication."""
    ordered = sorted(regions)
    return [r for i, r in enumerate(ordered) if i % num_hosts == host_id]


def stripe_reads(reads, num_hosts: int, host_id: int):
    """Deterministic read-level round-robin shard.

    Fallback for when hosts outnumber regions (e.g. one contig, N hosts):
    every host streams the same region list — reads arrive in the same
    deterministic coordinate order on all hosts — and keeps every
    ``num_hosts``-th read. Duplicate-free by construction; decode cost is
    replicated, so region sharding is preferred whenever regions >= hosts."""
    for i, r in enumerate(reads):
        if i % num_hosts == host_id:
            yield r


def barrier(name: str = "npore") -> None:
    """Barrier over every rank on the gloo group (no-op without a process
    group); ``name`` labels the call site in an error."""
    if not dist.is_initialized():
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def allreduce_counts(counts):
    """Sum count arrays across ranks (identity without a process group):
    an int64 ``all_reduce`` on gloo, exact as the JAX package's
    gather-and-sum; each result keeps its input's dtype."""
    if not dist.is_initialized():
        return counts
    out = []
    for c in counts:
        c = np.asarray(c)
        t = torch.from_numpy(c.astype(np.int64))
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        out.append(t.numpy().astype(c.dtype))
    return out


def allreduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over ranks (``t`` itself without a process group): on
    the NCCL group for a CUDA tensor when one is up, otherwise through a
    CPU copy on gloo. Returns a tensor on ``t``'s device."""
    if not dist.is_initialized():
        return t
    if t.device.type == "cuda" and _nccl_group is not None:
        t = t.to(rank_device(), copy=True)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_nccl_group)
        return t
    c = t.cpu().clone()
    dist.all_reduce(c, op=dist.ReduceOp.SUM)
    return c.to(t.device)


def host_out_path(out_prefix: str, host_id: int, num_hosts: int) -> str:
    if num_hosts == 1:
        return f"{out_prefix}.sam"
    return f"{out_prefix}.h{host_id}.sam"


def merge_host_sams(out_prefix: str, num_hosts: int) -> str:
    """Merge per-host SAMs into one coordinate-sorted SAM (host 0 only).

    Headers must be identical across shards (same input BAM); records are
    merged by (rname order of first header's @SQ, pos, qname) so output is
    deterministic regardless of host count."""
    parts = [host_out_path(out_prefix, i, num_hosts)
             for i in range(num_hosts)]
    headers: List[str] = []
    sq_order = {}
    records = []
    for p in parts:
        with open(p) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith("@"):
                    if not headers or line not in headers:
                        if p == parts[0]:
                            headers.append(line)
                            if line.startswith("@SQ"):
                                sn = dict(x.split(":", 1)
                                          for x in line.split("\t")[1:])["SN"]
                                sq_order[sn] = len(sq_order)
                else:
                    f = line.split("\t")
                    records.append(
                        (sq_order.get(f[2], 1 << 30), int(f[3]), f[0], line))
    records.sort()
    out = f"{out_prefix}.sam"
    with open(out, "w") as fh:
        for h in headers:
            fh.write(h + "\n")
        for _, _, _, line in records:
            fh.write(line + "\n")
    return out
