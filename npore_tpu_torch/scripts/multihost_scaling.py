"""Multi-rank scaling of the port's realign CLI.

Launches ``npore_tpu_torch.cli.realign`` as N cooperating torch.distributed
processes (ranks) on this machine, checks that the merged SAM equals the
1-rank SAM record for record, and reports reads/s and the scaling
efficiency T1 / (N * TN) of the realignment stage (TN: the slowest rank's
``runtime`` line). With ``--engine cuda`` every rank drives the card
``cuda:(LOCAL_RANK mod device_count)``; ranks that share a card talk over
gloo. The counterpart of the JAX package's ``scripts/multihost_scaling.py``.

Usage:
    python -m npore_tpu_torch.scripts.multihost_scaling [--hosts 2 4] \\
        [--engine cuda|torch | --engines cuda torch] [--max_reads N] \\
        [--pin_cores K] [--bam ...] [--ref ...] [--stats_dir ...]

``--engines`` sweeps engines, each with its own 1-rank baseline;
``--max_reads`` passes on to the CLI; ``--pin_cores K`` gives each rank
its own K cores (taskset), the 1-rank run included, so that every rank
count runs on equal hardware a rank.

Prints one JSON line per engine and rank count: ``engine``, ``hosts``,
``reads``, ``seconds`` (the stage), ``wall_s`` (the processes from start
to exit), ``reads_per_s``, ``records_match_1host``, ``efficiency`` and per
rank its reads, stage seconds, bails, K1/K2 launches and peak device
memory.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "npore_tpu_torch.scripts.multihost_scaling"
REPORT = "RANK_REPORT "         # prefix of a rank's closing JSON line
TIMEOUT_S = 900
ENGINES = ("cuda", "torch")


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(argv: Sequence[str]) -> int:
    """One rank: run the realign CLI, then print its report. It fails if
    the run loaded ``jax`` or anything of the JAX package."""
    import torch
    from ..cli import realign
    from ..ops import dp_cuda, tb_cuda
    rl = realign.run(list(argv))
    rep = {"bails": rl.bail_count if rl is not None else 0,
           "k1_launches": dp_cuda.launches, "k2_launches": tb_cuda.launches,
           "peak_device_bytes": None}
    if rl is not None and rl.engine == "cuda":
        rep["peak_device_bytes"] = max(
            torch.cuda.max_memory_allocated(d) for d in rl._engine.devices)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "npore_tpu"))
    rep["loaded"] = bad
    print(REPORT + json.dumps(rep), flush=True)
    return 1 if bad else 0


def check_pin(n: int, pin_cores: int) -> None:
    """Raise SystemExit where ``n`` ranks of ``pin_cores`` cores each need
    more cores than the machine has."""
    if n * pin_cores > (os.cpu_count() or 1):
        raise SystemExit(f"--pin_cores {pin_cores} x {n} ranks exceeds "
                         f"{os.cpu_count()} cores")


def pinned(cmd: List[str], rank: int, n: int, pin_cores: int) -> List[str]:
    """``cmd`` on its rank's own ``pin_cores`` cores (taskset), or as it
    is for ``pin_cores`` 0."""
    if not pin_cores:
        return cmd
    check_pin(n, pin_cores)
    lo = rank * pin_cores
    return ["taskset", "-c", f"{lo}-{lo + pin_cores - 1}"] + cmd


def run_ranks(n: int, cli: List[str], workdir: str, tag: str,
              pin_cores: int = 0) -> dict:
    """Run the CLI with ``cli`` flags as ``n`` ranks (one plain process
    for ``n == 1``), each on its own ``pin_cores`` cores if that is not 0;
    returns the wall seconds, the slowest rank's stage seconds, the reads,
    and each rank's report with its reads and stage seconds. Raises if a
    rank fails."""
    port = free_port()
    cmds = []
    for h in range(n):
        cmd = [sys.executable, "-m", MODULE, "--worker"] + cli
        if n > 1:
            cmd += ["--num_hosts", str(n), "--host_id", str(h),
                    "--coordinator", f"localhost:{port}"]
        cmds.append(pinned(cmd, h, n, pin_cores))
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for h, cmd in enumerate(cmds):
            log = os.path.join(workdir, f"{tag}.rank{h}.log")
            logs.append(log)
            # output goes to files, not pipes: ranks meet at a barrier
            # before they exit, so a rank blocked on a full pipe (64 KB of
            # progress and warning lines) would hang the job
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    cmd, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:         # never leave a rank behind
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    out = {"hosts": n, "wall_s": wall, "seconds": 0.0, "reads": 0,
           "ranks": []}
    for h, (rc, log) in enumerate(zip(rcs, logs)):
        with open(log) as fh:
            text = fh.read()
        reps = [l[len(REPORT):] for l in text.splitlines()
                if l.startswith(REPORT)]
        if rc != 0 or not reps:
            sys.stderr.write(text[-4000:])
            raise RuntimeError(f"rank {h}/{n} ({tag}) exited {rc}")
        rep = json.loads(reps[-1])
        m = re.search(r"(\d+) reads realigned; runtime: ([0-9.]+)s", text)
        rep["reads"], rep["seconds"] = (int(m.group(1)), float(m.group(2))) \
            if m else (0, 0.0)
        out["ranks"].append(rep)
        out["reads"] += rep["reads"]
        out["seconds"] = max(out["seconds"], rep["seconds"])
    return out


def records(path: str) -> Dict[str, str]:
    """A SAM's records keyed by QNAME (the merged SAM is coordinate-sorted,
    a 1-rank SAM is in stream order)."""
    with open(path) as fh:
        return {l.split("\t", 1)[0]: l.rstrip("\n") for l in fh
                if not l.startswith("@")}


def scaling(hosts: Sequence[int], cli: List[str], workdir: str,
            rounds: int = 1, emit=print, pin_cores: int = 0,
            tag: str = "") -> List[dict]:
    """1 rank, then each of ``hosts``, ``rounds`` times in turns; each
    run's merged SAM compared with the first 1-rank SAM. ``cli`` holds
    every flag but ``--out_prefix``; ``tag`` prefixes the runs' files.
    Returns one row a run, efficiency against the 1-rank run of the same
    round."""
    rows, base = [], None
    for k in range(rounds):
        t1 = None
        for n in (1,) + tuple(h for h in hosts if h != 1):
            name = f"{tag}r{k}_n{n}"
            pre = os.path.join(workdir, name)
            row = run_ranks(n, cli + ["--out_prefix", pre], workdir, name,
                            pin_cores)
            recs = records(pre + ".sam")
            if base is None:
                base = recs
            row["round"] = k
            row["records_match_1host"] = recs == base
            row["reads_per_s"] = (row["reads"] / row["seconds"]
                                  if row["seconds"] else 0.0)
            if n == 1:
                t1 = row["seconds"]
            row["efficiency"] = t1 / (n * row["seconds"]) \
                if row["seconds"] else 0.0
            rows.append(row)
            emit(json.dumps(row))
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"]:
        return worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, nargs="+", default=[2])
    ap.add_argument("--engine", default="cuda", choices=ENGINES)
    ap.add_argument("--engines", nargs="+", choices=ENGINES, default=None,
                    help="engines to sweep, each against its own 1-rank "
                         "run (in place of --engine)")
    ap.add_argument("--max_reads", type=int, default=0)
    ap.add_argument("--pin_cores", type=int, default=0,
                    help="cores a rank (taskset), the 1-rank run "
                         "included")
    ap.add_argument("--bam", default=os.path.join(REPO, "tests/data/reads.bam"))
    ap.add_argument("--ref", default=os.path.join(REPO, "tests/data/ref.fasta"))
    ap.add_argument("--stats_dir", default=os.path.join(REPO, "guppy5_stats"))
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the sweep in turns (1, N..., 1, N...)")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
    check_pin(max(args.hosts), args.pin_cores)     # before any run
    rows = []
    with tempfile.TemporaryDirectory(prefix="npore_mh_") as tmp:
        for engine in args.engines or [args.engine]:
            cli = ["--bam", args.bam, "--ref", args.ref, "--stats_dir",
                   args.stats_dir, "--engine", engine]
            if args.max_reads:
                cli += ["--max_reads", str(args.max_reads)]

            def emit(line, engine=engine):
                print(json.dumps({"engine": engine, **json.loads(line)}),
                      flush=True)
            rows += scaling(args.hosts, cli, args.workdir or tmp,
                            args.rounds, emit, args.pin_cores,
                            f"{engine}_")
    return 0 if all(r["records_match_1host"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
