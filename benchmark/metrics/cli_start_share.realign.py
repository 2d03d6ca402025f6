"""The realign CLI's start (the FASTA, the region count, the tables, the
header: a call's wall time less the realign stage's printed runtime) as a
share of the calls' wall time."""
from benchmark import printed


def read(run):
    wall = start = 0.0
    for c in run.calls:
        rt = printed.realign_runtime(c["lines"])
        if rt is None:
            return None
        wall += c["t1"] - c["t0"]
        start += c["t1"] - c["t0"] - rt[1]
    return 100 * start / wall if wall else None
