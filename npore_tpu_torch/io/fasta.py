"""Minimal FASTA reader/writer (replaces Biopython SeqIO + pysam.FastaFile;
reference: src/util.py:7-8, src/util.py:20)."""
from __future__ import annotations

import gzip
import os
from typing import Dict, List, Optional, Tuple


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class FastaFile:
    """Loads a FASTA into memory; provides contig-level random access.

    Test-scale and chromosome-scale FASTAs fit comfortably in host RAM
    (GRCh38 ~3GB); a .fai-indexed lazy reader can be added if needed.
    """

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(f"could not open FASTA '{path}'")
        self.path = path
        self._seqs: Dict[str, str] = {}
        self._order: List[str] = []
        name = None
        parts: List[str] = []
        with _open(path) as fh:
            for line in fh:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        self._seqs[name] = "".join(parts)
                    name = line[1:].split()[0]
                    self._order.append(name)
                    parts = []
                elif line:
                    parts.append(line)
        if name is not None:
            self._seqs[name] = "".join(parts)

    @property
    def references(self) -> List[str]:
        return list(self._order)

    @property
    def lengths(self) -> List[int]:
        return [len(self._seqs[c]) for c in self._order]

    def get_reference_length(self, contig: str) -> int:
        return len(self._seqs[contig])

    def fetch(self, contig: str, start: Optional[int] = None,
              end: Optional[int] = None) -> str:
        """Contig slice [start, end), 0-based (like get_fasta, src/util.py:7-8)."""
        return self._seqs[contig][start:end]

    def __contains__(self, contig: str) -> bool:
        return contig in self._seqs

    def items(self) -> List[Tuple[str, str]]:
        return [(c, self._seqs[c]) for c in self._order]


def get_fasta(path: str, contig: str, start: Optional[int] = None,
              end: Optional[int] = None) -> str:
    """One-shot contig fetch (reference: src/util.py:7-8)."""
    return FastaFile(path).fetch(contig, start, end)


def write_fasta(path: str, contigs: Dict[str, str], width: int = 80) -> None:
    with open(path, "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")
