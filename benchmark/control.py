"""The control of a cell's comparison: ``python benchmark/control.py
--workload <cell> --seeds <n>,<n>,...`` on the card, from the checkout's
root, prints for each seed the numbers the comparison reads where the
program is replaced by the reference computed in bfloat16, the precision
below the configuration's float32. Each seed's line must fail a limit.
The benchmark's runs do not run it."""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    import importlib

    import torch
    if not torch.cuda.is_available():
        print("error: the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(a.workload)
    cfg = harness.resolve(cell["config"])
    mod = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    for seed in map(int, a.seeds.split(",")):
        inputs = harness.inputs_for(cell, seed)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            got = mod.Entry(cfg, cell["workload"], inputs, d).control(
                torch.device("cuda"))
        print(json.dumps({"seed": seed, "control": got,
                          "fails": any(v > 0 for v in got.values()),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
