"""What the realign CLI is to write for the benchmark's input, worked out
again from the generator's files, and the comparison that decides
``correct`` for a realign cell.

Every record the CLI writes is compared with the line it is to be: one
record for each primary mapped read with MD on a FASTA contig
(``expected.jsonl``, written by the generator beside the BAM) and nothing
else, QNAME, FLAG, RNAME, POS, MAPQ, RNEXT, PNEXT, TLEN, SEQ, QUAL and the
HP tag as carried from the input. The CIGAR of every record is realigned
here from the FASTA, the read and its input CIGAR (``dp.align``),
normalised (``cigar.finalize``) and compared. Every number is a count of
records and every limit 0.
"""
from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from . import cigar, dp, scores

_LUT = np.zeros(256, dtype=np.uint8)
for _ch, _v in {"A": 1, "C": 2, "G": 3, "T": 4, "a": 1, "c": 2, "g": 3,
                "t": 4}.items():
    _LUT[ord(_ch)] = _v


def bases(s: str) -> np.ndarray:
    return _LUT[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]


def read_fasta(path: str) -> Dict[str, str]:
    out, name, parts = {}, None, []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                if name is not None:
                    out[name] = "".join(parts)
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line.strip())
    if name is not None:
        out[name] = "".join(parts)
    return out


def read_expected(path: str) -> List[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def ref_span(cig: str) -> int:
    return len(cig) - cig.count("I")


def expected_fields(e: dict) -> List[str]:
    """The line's fields but the CIGAR (src/bam.pyx:83): TLEN is the
    aligned reference span, SEQ and QUAL the read between its soft clips,
    HP 0 where the read has none."""
    return [e["qname"], str(e["flag"]), e["rname"], str(e["pos"] + 1),
            str(e["mapq"]), "*", "0", str(ref_span(e["cigar"])),
            e["seq"].upper(), e["qual"], f"HP:i:{e['hp']}"]


def read_sam(path: str) -> Dict[str, List[str]]:
    """The body lines of a SAM by QNAME; a QNAME written twice keeps a
    marker that fails the comparison."""
    out: Dict[str, List[str]] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            out[f[0]] = ["<written twice>"] if f[0] in out else f
    return out


def realign(rows: List[dict], genome: Dict[str, str], stats_dir: str,
            params: dp.AlignParams, device, dtype=torch.float32
            ) -> List[str]:
    """The CIGAR the realigner is to write for each row ("" where a window
    bailed: the reference cannot say)."""
    subs, nps = scores.load_counts(stats_dir)[:2]
    sub, nps_s = scores.score_matrices(subs, nps, params.max_n, params.max_l)
    cont = scores.cont_tables(nps_s, params.max_n, params.max_l)
    items = []
    for e in rows:
        span = ref_span(e["cigar"])
        items.append((bases(genome[e["rname"]][e["pos"]:e["pos"] + span]),
                      bases(e["seq"]), e["cigar"]))
    ext, bailed = dp.align(items, sub, cont, params, device, dtype)
    return ["" if b else cigar.finalize(x, ref, seq)
            for x, b, (ref, seq, _) in zip(ext, bailed, items)]


def compare(sam: Dict[str, List[str]], expected: List[dict],
            cigars: Dict[str, str]) -> Dict[str, int]:
    """Counts of records missing, extra, with a carried field wrong, and
    with a CIGAR other than the reference's (of those in ``cigars``)."""
    want = {e["qname"]: e for e in expected}
    out = {"records_missing": sum(q not in sam for q in want),
           "records_extra": sum(q not in want for q in sam),
           "fields_differing": 0, "cigars_differing": 0,
           "reference_bails": sum(not c for c in cigars.values())}
    for q, e in want.items():
        got = sam.get(q)
        if got is None:
            continue
        if got[:5] + got[6:] != expected_fields(e):
            out["fields_differing"] += 1
        if q in cigars and (len(got) < 6 or got[5] != cigars[q]):
            out["cigars_differing"] += 1
    return out


def check(sam_path: str, inputs: Dict[str, str], stats_dir: str,
          params: dp.AlignParams, device) -> Dict[str, int]:
    expected = read_expected(inputs["expected"])
    refs = realign(expected, read_fasta(inputs["fasta"]), stats_dir, params,
                   device)
    return compare(read_sam(sam_path), expected,
                   {e["qname"]: c for e, c in zip(expected, refs)})


def control(inputs: Dict[str, str], stats_dir: str, params: dp.AlignParams,
            device, dtype=torch.bfloat16) -> Dict[str, int]:
    """What the comparison reads where the program is this reference at
    ``dtype``: its records as the CLI writes them, against the float32
    reference."""
    expected = read_expected(inputs["expected"])
    genome = read_fasta(inputs["fasta"])
    good = realign(expected, genome, stats_dir, params, device)
    low = realign(expected, genome, stats_dir, params, device, dtype)
    sam = {}
    for e, c in zip(expected, low):
        f = expected_fields(e)
        sam[e["qname"]] = f[:5] + [c] + f[5:]
    return compare(sam, expected, {e["qname"]: c
                                   for e, c in zip(expected, good)})
