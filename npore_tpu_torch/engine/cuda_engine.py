"""Batched realignment engine: windows -> groups -> DP -> traceback.

The counterpart of ``npore_tpu/engine/pallas_engine.PallasEngine``. Windows
of a batch are sorted by row count and cut into groups; each group is
packed on the host into one flat byte buffer (``windows.pack_group``),
copied to the device once, run through the DP and the traceback, and its
CIGAR bytes and bail flags come back in one copy.

With ``plain=False`` (the ``cuda`` engine) the group runs kernels K1 and K2
on a stream of the engine's own: ``align_batch_async`` only enqueues work
(pinned buffers, non-blocking copies, an event per group), so the
Realigner's pipeline overlaps host work with the device. With
``plain=True`` (the ``torch`` engine) the group runs the plain PyTorch DP
and traceback on the engine's device, synchronously.

Bailed alignments (a traceback error; K1 itself never bails) are redone
with the exact golden aligner, as PallasEngine does. That fallback is the
algorithm's exact path, not a device fallback, and counts in
``bail_count``. The TPU engine's r_pad ladder, index planes, extended
rescue tier and compile caches have no counterpart here: a full-k lookup
cannot overflow, and nothing is compiled per shape.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig
from ..device import resolve_device
from ..ops import dp_cuda, tb_cuda
from ..ops.band_dp import check_band, pack_planes, window_dp
from ..ops.tables import tables_from_numpy
from ..ops.traceback import decode, traceback
from .windows import (Window, build_windows, group_layout, group_nbytes,
                      pack_group, tensor_views)

GROUP_WINDOWS = 1024            # windows per group (one CTA each in K1)
GROUP_CELLS = 1 << 21           # windows x rows per group: bounds the
                                # (B, R, 64) int32 planes at 512 MiB


class CudaEngine:
    def __init__(self, sub_scores: np.ndarray, np_scores: np.ndarray,
                 cfg: AlignConfig = AlignConfig(), device=None,
                 plain: bool = False):
        check_band(cfg)
        self.cfg = cfg
        self.plain = plain
        self.device = resolve_device("torch" if plain else "cuda", device)
        self.sub_scores = np.asarray(sub_scores, dtype=np.float32)
        self.np_scores = np_scores
        self.tables = tables_from_numpy(sub_scores, np_scores, cfg,
                                        self.device)
        self.group_windows = GROUP_WINDOWS
        self.bail_count = 0
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None

    def align_batch(self, items) -> List[str]:
        """items: sequence with .ref/.seq int arrays and .cigar (expanded).
        Returns extended CIGARs over '=XID'."""
        return self.align_batch_async(items)()

    def align_batch_async(self, items):
        """Enqueue a batch; returns a zero-arg collector of its CIGARs."""
        items = list(items)
        windows: List[Window] = []
        for i, it in enumerate(items):
            windows.extend(build_windows(it.ref, it.seq, it.cigar, self.cfg,
                                         aln_idx=i))
        windows.sort(key=lambda w: w.b_rows)
        pending = [(g, self._submit(g)) for g in self._groups(windows)]
        return lambda: self._finish(items, pending)

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
        cfg = self.cfg
        R = max(w.b_rows for w in group)
        L = max(max(w.n_ins + w.n_del for w in group), 1)
        layout = group_layout(len(group), R, cfg.max_n)
        if not self._cuda:
            buf, _ = pack_group(group, R, cfg.max_n)
            batch = tensor_views(torch.from_numpy(buf).to(self.device),
                                 layout)
            return self._run(batch, L).buf.cpu(), L, None
        host = torch.empty(group_nbytes(layout), dtype=torch.uint8,
                           pin_memory=True)
        pack_group(group, R, cfg.max_n, out=host.numpy())
        with torch.cuda.stream(self._stream):
            dev_buf = host.to(self.device, non_blocking=True)
            out = self._run(tensor_views(dev_buf, layout), L)
            res = torch.empty(out.buf.shape, dtype=torch.uint8,
                              pin_memory=True)
            res.copy_(out.buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return res, L, done

    def _run(self, batch, L: int):
        cfg = self.cfg
        if self.plain:
            packed = pack_planes(*window_dp(batch, self.tables, cfg))
            return traceback(packed, batch, cfg, L)
        packed = dp_cuda.band_dp(batch, self.tables, cfg)
        return tb_cuda.traceback(packed, batch, cfg, L)

    def _collect(self, group: Sequence[Window], handle
                 ) -> List[Tuple[str, bool]]:
        res, L, done = handle
        if done is not None:
            done.synchronize()
        B = len(group)
        raw = res.numpy()
        meta = raw[:8 * B].view(np.int32).reshape(B, 2)
        cig = raw[8 * B:].reshape(B, L)
        ends = np.fromiter((w.n_ins + w.n_del for w in group), np.int64, B)
        cigs, bails = decode(meta, cig, ends)
        return list(zip(cigs, bails))

    def _finish(self, items, pending) -> List[str]:
        cfg = self.cfg
        chunk_cigars: Dict[Tuple[int, int], str] = {}
        bailed = set()
        for group, handle in pending:
            for w, (cig, bail) in zip(group, self._collect(group, handle)):
                if bail:
                    bailed.add(w.key[0])
                chunk_cigars[w.key] = cig

        # golden fallback for bailed alignments; prefers the native C++
        # port (bit-exact, ~14x the python spec)
        for i in sorted(bailed):
            self.bail_count += 1
            it = items[i]
            from ..native import golden_align_native
            full = golden_align_native(it.ref, it.seq, it.cigar,
                                       self.sub_scores, self.np_scores, cfg)
            if full is None:
                from ..golden.align import align as golden_align
                full = golden_align(it.ref, it.seq, it.cigar,
                                    self.sub_scores, self.np_scores, cfg)
            # golden returns the whole alignment: replace its chunks
            for w in build_windows(it.ref, it.seq, it.cigar, cfg, aln_idx=i):
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
