"""Batched realignment engine: windows -> groups -> DP -> traceback.

The counterpart of ``npore_tpu/engine/pallas_engine.PallasEngine``. Windows
of a batch are sorted by row count and cut into groups. The host fills
the first part of each group's flat byte buffer (``windows.fill_group``:
bases, prefix-I counts and scalars) and copies it to the device once;
there the n-polymer scan writes the buffer's four int8 planes from the
bases, as the JAX engine's prepass scans on the accelerator; then the DP
and the traceback run, and the CIGAR bytes and bail flags come back in one
copy. ``windows.pack_group``, which scans on the host, is the reference
the device-built buffer is held to.

With ``plain=False`` (the ``cuda`` engine) the group runs kernels K4 (the
scan), K1 and K2 on a stream of the engine's own: ``align_batch_async``
only enqueues work (pinned buffers, non-blocking copies, an event per
group), so the
Realigner's pipeline overlaps host work with the device. At most
``GROUPS_IN_FLIGHT`` groups of a call wait on the device: a call with more
(a whole contig of ``standardize_vcf``) collects its oldest group before it
submits the next, so the pinned host buffers stay bounded by that count,
not by the call's size. With
``plain=True`` (the ``torch`` engine) the group runs the plain PyTorch
scan, DP and traceback on the engine's device, synchronously.

Over several devices (``devices=``) the groups go round-robin: each
submitted group runs on the next device of the list, with that device's
stream and copy of the score tables, so groups on different cards run at
once (the JAX ``PallasEngine``'s group round-robin over its local chips).
By default the ``cuda`` engine takes every visible card, or under a process
group the rank's one card (``parallel.distributed.local_devices``).
``GROUPS_IN_FLIGHT`` holds per device; ``windows``, ``groups`` and
``wait_s`` count for the whole engine.

With the tracer on (``tracing``), a batch's window build is the span
``engine.windows``, each group's fill, copy and launches ``engine.submit``
and its wait on the device ``engine.collect`` (the same clock pair as
``wait_s``), both with the group's index, and the golden fallback
``engine.golden``; the counter ``engine.h2d_bytes`` adds up the buffer
prefixes copied to the devices.

Bailed alignments (a traceback error; K1 itself never bails) are redone
with the exact golden aligner, as PallasEngine does. That fallback is the
algorithm's exact path, not a device fallback, and counts in
``bail_count``. The TPU engine's r_pad ladder, index planes, extended
rescue tier and compile caches have no counterpart here: a full-k lookup
cannot overflow, and nothing is compiled per shape.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from time import perf_counter_ns
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig
from ..device import resolve_device
from .. import tracing
from ..ops import dp_cuda, npinfo_cuda, tb_cuda
from ..ops.band_dp import check_band, pack_planes, window_dp
from ..ops.tables import tables_from_numpy
from ..ops.traceback import decode, traceback
from ..parallel.distributed import local_devices
from .windows import (Window, build_windows, fill_group, group_layout,
                      group_nbytes, prefix_nbytes, tensor_views)

GROUP_WINDOWS = 1024            # windows per group (one CTA each in K1)
GROUP_CELLS = 1 << 21           # windows x rows per group: bounds the
                                # (B, R, 64) int32 planes at 512 MiB
GROUPS_IN_FLIGHT = 4            # submitted, uncollected groups per call:
                                # bounds the pinned buffers (~62 MB a group
                                # of 20,000-row windows)


class CudaEngine:
    def __init__(self, sub_scores: np.ndarray, np_scores: np.ndarray,
                 cfg: AlignConfig = AlignConfig(), device=None,
                 plain: bool = False, devices=None):
        check_band(cfg)
        self.cfg = cfg
        self.plain = plain
        engine = "torch" if plain else "cuda"
        if devices is None:
            if device is None and not plain:
                resolve_device(engine)          # raises without a card
                devices = local_devices()
            else:
                devices = [device]
        self.devices = [resolve_device(engine, d) for d in devices]
        if not self.devices:
            raise ValueError("CudaEngine needs at least one device")
        self.sub_scores = np.asarray(sub_scores, dtype=np.float32)
        self.np_scores = np_scores
        self._tables = {d: tables_from_numpy(sub_scores, np_scores, cfg, d)
                        for d in dict.fromkeys(self.devices)}
        self.group_windows = GROUP_WINDOWS
        self.bail_count = 0
        self.windows = 0        # windows and groups run, and the seconds
        self.groups = 0         # spent waiting on the device for results
        self.wait_s = 0.0
        self._wait_lock = threading.Lock()   # a submit and a collect thread
        self._cuda = self.devices[0].type == "cuda"
        self._streams = {d: torch.cuda.Stream(d) for d in self._tables} \
            if self._cuda else {}
        self._next_device = itertools.cycle(self.devices)

    def align_batch(self, items) -> List[str]:
        """items: sequence with .ref/.seq int arrays and .cigar (expanded).
        Returns extended CIGARs over '=XID'."""
        return self.align_batch_async(items)()

    def align_batch_async(self, items):
        """Enqueue a batch; returns a zero-arg collector of its CIGARs."""
        items = list(items)
        windows: List[Window] = []
        with tracing.span("engine.windows"):
            for i, it in enumerate(items):
                windows.extend(build_windows(it.ref, it.seq, it.cigar,
                                             self.cfg, aln_idx=i))
            windows.sort(key=lambda w: w.b_rows)
        self.windows += len(windows)
        done, pending = [], deque()
        for g in self._groups(windows):
            if len(pending) == GROUPS_IN_FLIGHT * len(self.devices):
                done.append(self._collect(*pending.popleft()))
            pending.append((g, self._submit(g)))
            self.groups += 1
        return lambda: self._finish(
            items, done + [self._collect(*p) for p in pending])

    def _groups(self, windows: Sequence[Window]):
        """Cut row-sorted windows into groups bounded by count and cells."""
        lo = 0
        while lo < len(windows):
            hi = lo + 1
            while (hi < len(windows) and hi - lo < self.group_windows
                   and (hi - lo + 1) * windows[hi].b_rows <= GROUP_CELLS):
                hi += 1
            yield windows[lo:hi]
            lo = hi

    def _submit(self, group: Sequence[Window]):
        """Enqueue ``group`` on the next device of the round-robin: the
        host fills the buffer's prefix, the device its n-polymer planes.
        The handle ends with the group's index in the engine."""
        index = self.groups
        with tracing.span("engine.submit", group=index):
            return self._enqueue(group) + (index,)

    def _enqueue(self, group: Sequence[Window]):
        """(result, L, done event) of ``group``."""
        cfg = self.cfg
        dev = next(self._next_device)
        tables = self._tables[dev]
        R = max(w.b_rows for w in group)
        L = max(max(w.n_ins + w.n_del for w in group), 1)
        layout = group_layout(len(group), R, cfg.max_n)
        nbytes = group_nbytes(layout)
        if not self._cuda:
            head = fill_group(group, R, cfg.max_n)
            buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            buf[:len(head)] = torch.from_numpy(head)
            tracing.count("engine.h2d_bytes", len(head))
            return self._run(tensor_views(buf, layout), L,
                             tables).buf.cpu(), L, None
        host = torch.empty(prefix_nbytes(layout), dtype=torch.uint8,
                           pin_memory=True)
        fill_group(group, R, cfg.max_n, out=host.numpy())
        stream = self._streams[dev]
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            dev_buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            dev_buf[:host.numel()].copy_(host, non_blocking=True)
            out = self._run(tensor_views(dev_buf, layout), L, tables)
            res = torch.empty(out.buf.shape, dtype=torch.uint8,
                              pin_memory=True)
            res.copy_(out.buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        tracing.count("engine.h2d_bytes", host.numel())
        return res, L, done

    def _run(self, batch, L: int, tables):
        """The n-polymer planes, the DP and the traceback of a group whose
        buffer holds ``fill_group``'s prefix."""
        cfg = self.cfg
        if self.plain:
            npinfo_cuda.fill_planes_plain(batch, cfg)
            packed = pack_planes(*window_dp(batch, tables, cfg))
            return traceback(packed, batch, cfg, L)
        npinfo_cuda.fill_planes(batch, cfg)
        packed = dp_cuda.band_dp(batch, tables, cfg)
        return tb_cuda.traceback(packed, batch, cfg, L)

    def _collect(self, group: Sequence[Window], handle):
        """The group's windows with their (CIGAR, bail) pairs."""
        res, L, done, index = handle
        t0 = perf_counter_ns()
        if done is not None:
            done.synchronize()
        t1 = perf_counter_ns()
        tracing.record("engine.collect", t0, t1, group=index)
        with self._wait_lock:
            self.wait_s += (t1 - t0) / 1e9
        B = len(group)
        raw = res.numpy()
        meta = raw[:8 * B].view(np.int32).reshape(B, 2)
        cig = raw[8 * B:].reshape(B, L)
        ends = np.fromiter((w.n_ins + w.n_del for w in group), np.int64, B)
        cigs, bails = decode(meta, cig, ends)
        return group, list(zip(cigs, bails))

    def _finish(self, items, collected) -> List[str]:
        cfg = self.cfg
        chunk_cigars: Dict[Tuple[int, int], str] = {}
        bailed = set()
        for group, results in collected:
            for w, (cig, bail) in zip(group, results):
                if bail:
                    bailed.add(w.key[0])
                chunk_cigars[w.key] = cig

        # golden fallback for bailed alignments; prefers the native C++
        # port (bit-exact, ~14x the python spec)
        with tracing.span("engine.golden"):
            for i in sorted(bailed):
                self.bail_count += 1
                it = items[i]
                from ..native import golden_align_native
                full = golden_align_native(it.ref, it.seq, it.cigar,
                                           self.sub_scores, self.np_scores,
                                           cfg)
                if full is None:
                    from ..golden.align import align as golden_align
                    full = golden_align(it.ref, it.seq, it.cigar,
                                        self.sub_scores, self.np_scores, cfg)
                # golden returns the whole alignment: replace its chunks
                for w in build_windows(it.ref, it.seq, it.cigar, cfg,
                                       aln_idx=i):
                    chunk_cigars.pop(w.key, None)
                chunk_cigars[(i, 0)] = full

        out = []
        for i in range(len(items)):
            parts = []
            ci = 0
            while (i, ci) in chunk_cigars:
                parts.append(chunk_cigars[(i, ci)])
                ci += 1
            out.append("".join(parts))
        return out
