"""Region fetches from a coordinate-sorted BAM in one pass, and the
confusion counts of the realign CLI's training over them.

The port's C++ BAM decoder (``native/bamio.cpp``, a copy held to the JAX
package's) seeks every region fetch to the sparse index it builds while
it scans, and it decides whether the BAM is sorted from the records it
scans (``sorted_ok``, bamio.cpp:550-553) without forgetting, on a seek,
the last record it saw. A fetch that seeks back past that record (the
next contig's first record, where the last fetch stopped, or a read that
crosses into the next range) re-reads smaller positions, and the decoder
declares the BAM unsorted: from then on every fetch rewinds to the
file's first record (:480) and scans to its end (:591, :600). A region
count over a genome's contigs, the realign CLI's fetch of each contig
and the training's fetch of each 100 kb range then decode the whole file
once each.

``SortedBamReader`` reads on from where the decoder stopped whenever a
fetch starts at or after the end of the last one, which the decoder
allows for (it leaves the first record past a region unconsumed), and
hands back the last fetch's records that reach into the new region; it
seeks only for a region that lies before. ``confusion_counts`` gives
each worker process a run of consecutive ranges in the file's order, so
each worker reads its part of the file once.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..io.bam_native import NativeBamReader, native_available
from .regions import Region, get_ranges
from .stats import (_zero_counts, calc_confusion_matrices_bam,
                    calc_confusion_matrices_range)


class SortedBamReader(NativeBamReader):
    """``NativeBamReader`` over a coordinate-sorted BAM whose fetches in
    the file's order decode each record once. ``skip_flags``: records
    with any of these flags the decoder drops before it builds them (or
    preps them)."""

    def __init__(self, path: str, prep: bool = True, skip_flags: int = 0):
        super().__init__(path, prep)
        self.skip_flags = skip_flags
        # (ref id, stop) of the last fetch that ran to its end, and its
        # records that reach past that stop
        self._last: Optional[Tuple[int, int]] = None
        self._carry: List = []

    def _records(self):
        self._lib.bamio_set_filter(self._h, self.skip_flags,
                                   1 if self.prep else 0)
        return super()._records()

    def __iter__(self):
        self._last = None
        return super().__iter__()

    def fetch(self, contig: Optional[str] = None,
              start: Optional[int] = None, stop: Optional[int] = None):
        last, self._last = self._last, None
        if contig not in self.references:
            yield from super().fetch(contig, start, stop)
            return
        rid = self.references.index(contig)
        lo = 0 if start is None else start
        hi = self.lengths[rid] - 1 if stop is None else stop
        carry = []
        if (last is not None and (rid, lo) >= last
                and self._lib.bamio_sorted(self._h)):
            # read on: the decoder stopped before the first record past
            # the last region, and each record before it that this region
            # holds (its end past ``lo``) ends past that region's stop
            carry = [r for r in self._carry if r.rname == contig
                     and r.reference_end > lo and r.pos <= hi]
            records = self._read_on(rid, start, stop)
        else:
            records = super().fetch(contig, start, stop)
        # a fetch to the contig's end leaves nothing a later fetch of the
        # contig could read on from (and needs no record's end)
        whole = hi >= self.lengths[rid] - 1
        tail = []
        for r in carry:
            yield r
            if r.reference_end > hi:
                tail.append(r)
        for r in records:
            yield r
            if not whole and r.reference_end > hi:
                tail.append(r)
        self._last = (rid, self.lengths[rid] if whole else hi)
        self._carry = tail

    def _read_on(self, rid: int, start: Optional[int], stop: Optional[int]):
        """The region's records from the decoder's position, no seek."""
        lib = self._lib
        lib.bamio_set_region(self._h, rid, -1 if start is None else start,
                             -1 if stop is None else stop)
        try:
            yield from self._records()
        finally:
            lib.bamio_set_region(self._h, -2, -1, -1)


def file_order(references: List[str], regions: List[Region]) -> List[Region]:
    """``regions`` in a coordinate-sorted BAM's order: by the header's
    contig order, then start and stop."""
    rid = {c: i for i, c in enumerate(references)}
    return sorted(regions, key=lambda r: (rid.get(r[0], len(rid)), r[1],
                                          r[2]))


def _run_worker(job):
    """Counts of a run of consecutive ranges, through one reader."""
    (bam_path, ref_path, ranges, max_n, max_l, min_bq) = job
    from ..io.fasta import FastaFile
    bam = SortedBamReader(bam_path, prep=False)
    fa = FastaFile(ref_path)
    acc = list(_zero_counts(max_n, max_l))
    contig, ref = None, None
    for c, s, e in ranges:
        if c != contig:
            contig, ref = c, fa.fetch(c)
        for a, p in zip(acc, calc_confusion_matrices_range(
                bam, ref, c, s, e, max_n, max_l, min_bq)):
            a += p
    bam.close()
    return acc


def confusion_counts(bam_path: str, ref_fa, regions: List[Region], cfg,
                     processes: int = 0):
    """``engine.stats.calc_confusion_matrices_bam``'s counts (the same
    chunk_width ranges, ``calc_confusion_matrices_range`` on each), with
    the ranges in the file's order and each of ``processes`` workers (0:
    the CPU count) given one run of consecutive ranges; that function's
    own for a SAM, or without the C++ library."""
    if not (bam_path.endswith(".bam") and native_available()):
        return calc_confusion_matrices_bam(bam_path, ref_fa, regions, cfg,
                                           processes)
    max_n, max_l = cfg.align.max_n, cfg.align.max_l
    bam = NativeBamReader(bam_path, prep=False)
    ranges = file_order(bam.references, list(get_ranges(regions,
                                                        cfg.chunk_width)))
    bam.close()
    if not ranges:
        return _zero_counts(max_n, max_l)
    if processes == 0:
        processes = min(os.cpu_count() or 1, len(ranges))
    runs = [r for r in np.array_split(np.arange(len(ranges)), processes)
            if len(r)]
    jobs = [(bam_path, ref_fa.path, [ranges[i] for i in r], max_n, max_l,
             cfg.min_bq) for r in runs]
    acc = list(_zero_counts(max_n, max_l))
    if len(jobs) > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(len(jobs)) as pool:
            parts = pool.map(_run_worker, jobs)
    else:
        parts = [_run_worker(jobs[0])]
    for part in parts:
        for a, p in zip(acc, part):
            a += p
    return tuple(acc)
