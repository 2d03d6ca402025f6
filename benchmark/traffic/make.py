"""The benchmark's input generator: ``python -m benchmark.traffic.make
--traffic <json> --seed <n> --out <dir>`` from the checkout's root makes a
cell's input from the seed, as its traffic file (given as JSON) says, into
``<dir>``: written under a temporary name, then renamed, so that a
directory that exists is whole. It runs in a process of its own, so that
the generator's memory stays out of the measured process."""
from __future__ import annotations

import argparse
import json
import os
import shutil

from . import genome_bam

GENERATORS = {
    "genome_bam": lambda seed, t, d: genome_bam.write(
        d, genome_bam.make(seed, genome_bam.Layout.from_json(t["layout"]))),
}


def make(traffic: dict, seed: int, out: str) -> None:
    tmp = out + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    GENERATORS[traffic["generator"]](seed, traffic, tmp)
    os.replace(tmp, out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    make(json.loads(a.traffic), a.seed, a.out)


if __name__ == "__main__":
    main()
