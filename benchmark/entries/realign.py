"""The realign CLI as a benchmark entry: ``npore_tpu_torch.cli.realign.run``
called in process on the cell's BAM and FASTA with the configuration's
flags, one SAM a call."""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..reference import dp
from ..reference import realign as ref_realign


class Entry:
    """``cfg`` and ``workload``: the configuration's and the cell's files;
    ``inputs``: the generator's paths; ``outdir``: where the calls write;
    ``engine`` in place of the configuration's (the CPU tests)."""

    program_files = ("bam", "fasta")   # what the program reads

    def __init__(self, cfg: dict, workload: dict, inputs: Dict[str, str],
                 outdir: str, engine: str = None):
        from npore_tpu_torch.cli import realign
        self._run = realign.run
        self.cfg = cfg
        self.workload = workload
        self.inputs = inputs
        self.outdir = outdir
        self.flags = list(cfg["cli"])
        if engine is not None:
            self.flags[self.flags.index("--engine") + 1] = engine

    def argv(self, prefix: str) -> List[str]:
        return (["--bam", self.inputs["bam"], "--ref", self.inputs["fasta"],
                 "--out_prefix", prefix] + self.flags)

    warm_calls = 2

    def warm(self) -> None:
        """Whole calls on the same input: every group size, buffer and
        pool the window's calls use is made here. A call on its first 512
        reads left the window's first calls slower than the rest, and after
        one whole call the window's first call still ran up to 1.25 times
        its run's median; the second warm call takes that."""
        prefix = os.path.join(self.outdir, "warm")
        for _ in range(self.warm_calls):
            self._run(self.argv(prefix))
            os.remove(prefix + ".sam")

    def call(self, k: int) -> Dict[str, float]:
        """Call ``k``; the engine's counters of the call."""
        r = self._run(self.argv(self.output(k)[:-len(".sam")]))
        eng = r._engine
        return {"wait_s": eng.wait_s, "windows": eng.windows,
                "groups": eng.groups, "bails": eng.bail_count,
                "skipped": len(r.skipped)}

    def output(self, k: int) -> str:
        return os.path.join(self.outdir, f"call{k}.sam")

    def discard(self, k: int) -> None:
        os.remove(self.output(k))

    def work(self, sam: str) -> float:
        """Aligned read bases written to ``sam``, in kb."""
        n = 0
        with open(sam) as fh:
            for line in fh:
                if not line.startswith("@"):
                    n += len(line.split("\t", 10)[9])
        return n / 1000

    def alignments(self) -> List[Tuple[int, int]]:
        """(reference span, query length) of each alignment of a call."""
        return [(ref_realign.ref_span(e["cigar"]), len(e["seq"]))
                for e in ref_realign.read_expected(self.inputs["expected"])]

    def check(self, sam: str, device) -> Dict[str, int]:
        return ref_realign.check(
            sam, self.inputs, self.cfg["stats_dir"],
            dp.AlignParams(**self.cfg["align"]), device)

    def control(self, device) -> Dict[str, int]:
        """The comparison's numbers with the reference in bfloat16 in the
        program's place."""
        return ref_realign.control(
            self.inputs, self.cfg["stats_dir"],
            dp.AlignParams(**self.cfg["align"]), device)
