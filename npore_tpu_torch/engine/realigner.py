"""Batched realignment orchestration (the port of
``npore_tpu/engine/realigner.py``).

    reads -> windows (host) -> row-sorted groups -> DP + traceback (device)
          -> per-read CIGAR reassembly -> normalize -> SAM

Every chunk of every read is an independent work item (chunks re-anchor on
the original path), so windows from different reads mix freely in a group.
Engines: ``cuda`` (kernels K1/K2 on the given card, by default on every
visible card, or the rank's one card under a process group), ``torch``
(the plain PyTorch DP and traceback on the given device, the CPU by
default) and ``golden`` (the executable spec, on the host).
"""
from __future__ import annotations

import dataclasses
import itertools
from time import perf_counter_ns
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .. import tracing
from ..config import AlignConfig
from ..constants import bases_to_int
from ..io.cigar import expand_cigar, finalize_cigar
from ..io.sam import SamRecord

ENGINES = ("cuda", "torch", "golden")


@dataclasses.dataclass
class AlignItem:
    """One alignment job: int-encoded ref window, query, expanded CIGAR."""
    ref: np.ndarray
    seq: np.ndarray
    cigar: str


class Realigner:
    def __init__(self, sub_scores: np.ndarray, np_scores: np.ndarray,
                 cfg: AlignConfig = AlignConfig(), engine: str = "cuda",
                 device=None):
        if engine == "auto":            # RealignConfig's default: the
            engine = "cuda"             # realign CLI's default engine
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} ({'|'.join(ENGINES)})")
        self.cfg = cfg
        self.engine = engine
        self.sub_scores = sub_scores
        self.np_scores = np_scores
        self.errors: List[str] = []
        self.skipped: List[str] = []
        self._engine = None
        if engine != "golden":
            from .cuda_engine import CudaEngine
            self._engine = CudaEngine(sub_scores, np_scores, cfg,
                                      device=device, plain=engine == "torch")

    @property
    def bail_count(self) -> int:
        return self._engine.bail_count if self._engine else 0

    def align_batch(self, items: Sequence[AlignItem]) -> List[str]:
        """Realign a batch of alignments; returns extended CIGARs ('=XID')."""
        if self._engine is None:
            from ..golden.align import align as golden_align
            return [golden_align(it.ref, it.seq, it.cigar, self.sub_scores,
                                 self.np_scores, self.cfg, self.errors)
                    for it in items]
        return self._engine.align_batch(items)

    # ------------------------------------------------------------------
    def realign_records(self, reads: Iterable[SamRecord],
                        batch_size: int = 128,
                        prefetch: int = 2) -> Iterable[SamRecord]:
        """Full read pipeline (reference: src/bam.pyx:51-89): strip clips,
        realign, left-normalize to fixpoint, emit the new SAM record with
        preserved identity fields and an HP tag. The records of
        ``realign_batches``, one by one."""
        for _, records in self.realign_batches(reads, batch_size, prefetch):
            yield from records

    def realign_batches(self, reads: Iterable[SamRecord],
                        batch_size: int = 128, prefetch: int = 2
                        ) -> Iterable[Tuple[int, List[SamRecord]]]:
        """(batch index, records) of each batch of ``batch_size`` reads, in
        order. Three host stages on dedicated threads, so the main thread
        only yields ready batches:

            producer: stream/decode reads into batches
            stage A : prep + window building + async device dispatch
            stage B : device collect + CIGAR finalize + SAM assembly

        With ``NPORE_TIMING=1`` the tracer records a batch's
        ``pipeline.decode`` (producer), ``pipeline.stage_a`` and
        ``pipeline.stage_b`` (with ``pipeline.finalize`` and
        ``pipeline.sam_build``), and the main thread's
        ``pipeline.decode_wait`` and ``pipeline.main_wait``, all under the
        context of the caller's open span (or a call of their own), and
        prints the per-read ``[timing]`` line from them.
        """
        import queue
        import threading
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        timing = tracing.set_from_env()
        ctx = tracing.context()
        since = perf_counter_ns()
        n_done = 0

        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))

        def producer():
            it = iter(reads)
            try:
                for b in itertools.count():
                    with tracing.span("pipeline.decode", batch=b,
                                      parent=ctx):
                        batch = list(itertools.islice(it, batch_size))
                    if not batch:
                        break
                    q.put(batch)
                q.put(None)
            except BaseException as e:       # surface in the consumer
                q.put(e)

        def stage_a(b, batch):
            with tracing.span("pipeline.stage_a", batch=b, parent=ctx):
                items, meta = self._prep_batch(batch)
                if self._engine is not None:
                    collect = self._engine.align_batch_async(items)
                else:
                    collect = (lambda its: lambda: self.align_batch(its))(
                        items)
            return meta, collect

        def stage_b(b, fut_a):
            meta, collect = fut_a.result()
            with tracing.span("pipeline.stage_b", batch=b, parent=ctx):
                return self._finalize_records(meta, collect())

        def wait(name, b, get):
            with tracing.span(name, batch=b, parent=ctx):
                return get()

        t = threading.Thread(target=producer, daemon=True,
                             name="npore-decode")
        t.start()
        ex_a = ThreadPoolExecutor(1, thread_name_prefix="npore-stage-a")
        ex_b = ThreadPoolExecutor(1, thread_name_prefix="npore-stage-b")
        inflight: deque = deque()
        try:
            for b in itertools.count():
                item = wait("pipeline.decode_wait", b, q.get)
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                inflight.append((b, ex_b.submit(
                    stage_b, b, ex_a.submit(stage_a, b, item))))
                while len(inflight) > 2:
                    k, fut = inflight.popleft()
                    out = wait("pipeline.main_wait", k, fut.result)
                    n_done += len(out)
                    yield k, out
            while inflight:
                k, fut = inflight.popleft()
                out = wait("pipeline.main_wait", k, fut.result)
                n_done += len(out)
                yield k, out
            t.join()
        finally:
            for _, f in inflight:
                f.cancel()
            # cancel_futures drops queued stage tasks so an aborted run
            # cannot dispatch device work nobody will collect
            ex_a.shutdown(wait=False, cancel_futures=True)
            ex_b.shutdown(wait=False, cancel_futures=True)
            for _, f in inflight:
                if not f.cancelled():
                    exc = None
                    try:
                        exc = f.exception(timeout=60)
                    except Exception as e:
                        exc = e
                    if exc is not None:
                        self.errors.append(f"pipeline abort: {exc!r}")
        if timing and n_done:
            self._print_timing(ctx.call, since, n_done)

    @staticmethod
    def _print_timing(call: int, since: int, n_done: int) -> None:
        """The per-read µs of each stage of a pipeline run, from its
        spans: submit is stage A, collect-wait the engine's waits on the
        device within stage B, finalize+emit the rest of stage B."""
        spans = [s for s in tracing.read()["spans"]
                 if s.call == call and s.t0 >= since]
        stage_b = {s.id for s in spans if s.name == "pipeline.stage_b"}
        ns = tracing.totals(call, since)
        coll = sum(s.t1 - s.t0 for s in spans
                   if s.name == "engine.collect" and s.parent in stage_b)
        us = 1e-3 / n_done
        print(f"    [timing] per read: "
              f"submit {ns.get('pipeline.stage_a', 0) * us:.0f}us, "
              f"collect-wait {coll * us:.0f}us, "
              f"finalize+emit "
              f"{(ns.get('pipeline.stage_b', 0) - coll) * us:.0f}us, "
              f"decode-wait {ns.get('pipeline.decode_wait', 0) * us:.0f}us, "
              f"main-wait {ns.get('pipeline.main_wait', 0) * us:.0f}us",
              flush=True)

    def _prep_batch(self, reads: List[SamRecord]):
        items = []
        meta = []
        for read in reads:
            aln = getattr(read, "aln", None)
            if aln is not None:              # native decoder prep fast path
                int_ref, int_seq, cig = aln
                items.append(AlignItem(int_ref, int_seq, cig))
                meta.append((read, int_ref, int_seq))
                continue
            try:
                cig = expand_cigar(read.cigar).replace("S", "").replace("H", "")
                int_ref = bases_to_int(read.get_reference_sequence().upper())
                int_seq = bases_to_int(read.query_alignment_sequence.upper())
            except (ValueError, KeyError, IndexError) as e:
                # tolerate malformed records the way the reference's pysam
                # path does: skip with a warning instead of aborting
                self.skipped.append(f"read {read.qname} skipped: {e}")
                continue
            items.append(AlignItem(int_ref, int_seq, cig))
            meta.append((read, int_ref, int_seq))
        return items, meta

    def _finalize_records(self, meta, new_cigars) -> List[SamRecord]:
        # batched C++ finalization: one FFI call for the whole batch; falls
        # back per read without a compiler
        from ..native import finalize_cigar_batch
        with tracing.span("pipeline.finalize"):
            new_cigars = list(new_cigars)
            finals = finalize_cigar_batch(
                new_cigars, [m_[1] for m_ in meta], [m_[2] for m_ in meta])
            if finals is None:
                finals = [finalize_cigar(c, m_[1], m_[2])
                          for c, m_ in zip(new_cigars, meta)]
        out = []
        with tracing.span("pipeline.sam_build"):
            for (read, int_ref, int_seq), norm in zip(meta, finals):
                hap = int(read.get_tag("HP")) if read.has_tag("HP") else 0
                # output line fields per reference (src/bam.pyx:83); tlen
                # is the aligned reference span, len(int_ref)
                out.append(SamRecord(
                    qname=read.qname, flag=read.flag, rname=read.rname,
                    pos=read.pos, mapq=read.mapq, cigar=norm,
                    rnext="*", pnext=0, tlen=len(int_ref),
                    seq=read.query_alignment_sequence.upper(),
                    qual=read.query_alignment_qualities_str,
                    tags={"HP": ("i", hap)}))
        return out
