"""The benchmark's run: one cell, one seed, one measured window.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the checkout's root. The cell's files are found by
name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``, whose ``entry`` names the module under
``entries/`` that calls the program) and its traffic
(``traffic/<traffic>.json``, the parameters the generator reads);
``BENCHMARK.json`` says which metrics the cell reports, and each per-layer
metric is read by ``metrics/<metric>.py``.

A run: set-up (imports, the card, two warm calls; the input, from its
cache or made for the seed in a process of its own, is timed apart and
left out of ``setup_s``), then a closed loop of
whole calls, back to back, from the first call's start until the call
running at ``--seconds`` returns. Rates divide all the work of all the
calls by that whole window; each call's output but the last is deleted
as soon as the next call is due, its size kept. Then the import guard,
the memory readings, and the comparison with the reference, after the
program's state is freed. With ``--trace 1`` the window runs under ``torch.profiler`` (CUDA
activity only) with ``NPORE_TIMING=1`` and every line the program prints
timestamped; the per-layer metrics are read from those.

The last line of standard output is one JSON object; the compared numbers
with their limits are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import io
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "npore_tpu")


class LineLog(io.TextIOBase):
    """A stand-in for ``sys.stdout`` that keeps each line the program
    prints with the ``perf_counter`` time its newline was written."""

    def __init__(self):
        self.lines: List[Tuple[float, str]] = []
        self._part = ""

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        self._part += s
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)


class GcClock:
    """Seconds the cyclic collector ran in the window, by generation."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = 0.0

    def on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds[info["generation"]] += \
                time.perf_counter() - self._t0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str) -> dict:
    """The cell's workload (with its traffic's parameters in place of the
    traffic's name), configuration and metric entries, by name."""
    with open(os.path.join(HERE, "workloads", name + ".json")) as fh:
        wl = json.load(fh)
    with open(os.path.join(HERE, "configs", wl["config"] + ".json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(HERE, "traffic", wl["traffic"] + ".json")) as fh:
        wl = dict(wl, traffic=json.load(fh))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"name": name, "workload": wl, "config": cfg, "end_to_end": e2e,
            "per_layer": layer}


def resolve(cfg: dict) -> dict:
    """The configuration with its paths under the benchmark made absolute."""
    def fix(v):
        return os.path.join(ROOT, v) if isinstance(v, str) and \
            v.startswith("benchmark/") else v
    out = {k: fix(v) for k, v in cfg.items()}
    out["cli"] = [fix(v) for v in cfg["cli"]]
    return out


def inputs_for(cell: dict, seed: int, cache: str = CACHE
               ) -> Dict[str, str]:
    """The cell's input for ``seed``, made once into a fixed directory of
    the checkout by the generator, in a process of its own."""
    d = os.path.join(cache, "inputs", f"{cell['name']}-{seed}")
    traffic = cell["workload"]["traffic"]
    if not os.path.isdir(d):
        os.makedirs(os.path.dirname(d), exist_ok=True)
        subprocess.run([sys.executable, "-m", "benchmark.traffic.make",
                        "--traffic", json.dumps(traffic), "--seed",
                        str(seed), "--out", d], cwd=ROOT, check=True)
    return {k: os.path.join(d, f) for k, f in traffic["files"].items()}


def device_info(torch, chips: int) -> dict:
    power = ""
    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit": power}


def read_trace(path: str) -> dict:
    """Device intervals (µs, on the trace's clock) and kernel seconds by
    name from a chrome trace of ``torch.profiler``; the offset that takes
    the trace's µs to the host's epoch µs."""
    with open(path) as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", [])
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    kernel_s: Dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel":
            m = re.search(r"(\w+(<[^()]*>)?)\(", e["name"])
            name = m.group(1) if m else e["name"]
            kernel_s[name] = kernel_s.get(name, 0.0) + e.get("dur", 0) / 1e6
    base = doc.get("baseTimeNanoseconds")
    return {"spans": spans, "kernel_s": kernel_s,
            "to_epoch_us": base / 1e3 if base else 0.0}


def busy_union(spans: List[Tuple[float, float]]) -> Tuple[float, list]:
    """Seconds covered by the intervals, and the merged intervals (µs)."""
    merged: List[List[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged) / 1e6, merged


def stage_spans(calls: List[dict]) -> List[Tuple[float, float, str]]:
    """(start, end, stage) of every CLI stage of every call: a stage runs
    from its '> ' line to the next, the first from the call's start."""
    out = []
    for c in calls:
        t, label = c["t0"], "call start"
        for tl, line in c["lines"]:
            if line.startswith("> "):
                out.append((t, tl, label))
                t, label = tl, line[2:]
        out.append((t, c["t1"], label))
    return out


def stage_of(spans: List[Tuple[float, float, str]], a: float, b: float
             ) -> str:
    """The stage that covers most of [a, b] ('between calls' if none)."""
    share: Dict[str, float] = {}
    for s, e, label in spans:
        o = min(b, e) - max(a, s)
        if o > 0:
            share[label] = share.get(label, 0.0) + o
    return max(share, key=share.get) if share else "between calls"


class Run:
    """One run of a cell: what a metric reader may read."""

    def __init__(self, cell: dict):
        self.cell = cell
        self.calls: List[dict] = []
        self.window_s = 0.0
        self.calls_done = 0
        self.work_per_call = 0.0
        self.alignments: List[Tuple[int, int]] = []
        self.busy_s: Optional[float] = None
        self.kernel_s: Dict[str, float] = {}
        self.gaps: List[Tuple[str, float]] = []


def load_reader(name: str) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", os.path.join(HERE, "metrics",
                                                  name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             t_start: float, engine: Optional[str] = None,
             require_device: bool = True, device: str = "cuda",
             cache: str = CACHE) -> Tuple[int, Optional[dict]]:
    """Run the cell; (exit code, result or None). ``engine``,
    ``require_device``, ``device`` and ``cache`` are for the CPU tests."""
    import torch
    chips = cell["workload"]["chips"]
    if require_device and (not torch.cuda.is_available()
                           or torch.cuda.device_count() < chips):
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2, None
    if importlib.util.find_spec("npore_tpu_torch") is None:
        print("error: the program (npore_tpu_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2, None
    cfg = resolve(cell["config"])
    t_inputs = time.perf_counter()
    inputs = inputs_for(cell, seed, cache)
    entry_mod = importlib.import_module(f"benchmark.entries.{cfg['entry']}")
    outdir = tempfile.mkdtemp(prefix="npore_bench_")
    # the program reads copies written now: a run on a cached input reads
    # as freshly written a file as the run that made it (files written
    # minutes before read slower on the card's machine)
    for role in entry_mod.Entry.program_files:
        dst = os.path.join(outdir, "in_" + os.path.basename(inputs[role]))
        shutil.copyfile(inputs[role], dst)
        inputs = dict(inputs, **{role: dst})
    # the benchmark's own work, not the program's set-up: made for a new
    # seed, read from the cache for a seed seen before
    inputs_s = time.perf_counter() - t_inputs
    run = Run(cell)
    log = LineLog()
    gc_clock = GcClock()
    real_stdout = sys.stdout
    failed, prof = 0, None
    try:
        sys.stdout = log
        entry = entry_mod.Entry(cfg, cell["workload"], inputs, outdir,
                                engine)
        entry.warm()
        if require_device:
            torch.cuda.synchronize()
        # every run starts its window from the same collector state
        gc.collect()
        gc.callbacks.append(gc_clock.on_gc)
        if trace:
            os.environ["NPORE_TIMING"] = "1"
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if require_device else
                                       ProfilerActivity.CPU])
            prof.start()
        epoch_off = time.time() - time.perf_counter()
        w0 = time.perf_counter()
        setup_s = w0 - t_start - inputs_s
        k = 0
        while True:
            n0 = len(log.lines)
            c0, p0 = time.perf_counter(), time.process_time()
            try:
                counters = entry.call(k)
            except Exception:
                failed += 1
                traceback.print_exc(file=sys.stderr)
                counters = {}
            c1, p1 = time.perf_counter(), time.process_time()
            out = entry.output(k)
            run.calls.append({"t0": c0, "t1": c1, "cpu_s": p1 - p0,
                              "counters": counters,
                              "lines": log.lines[n0:],
                              "bytes": os.path.getsize(out)
                              if os.path.exists(out) else -1})
            if failed or c1 - w0 >= seconds:
                break
            entry.discard(k)     # before its pages reach the disk
            k += 1
        if require_device:
            torch.cuda.synchronize()
        w1 = time.perf_counter()
        run.window_s = w1 - w0
        if prof is not None:
            prof.stop()
    finally:
        sys.stdout = real_stdout
        os.environ.pop("NPORE_TIMING", None)
        if gc_clock.on_gc in gc.callbacks:
            gc.callbacks.remove(gc_clock.on_gc)
    peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    found = forbidden_modules()
    if found:
        print(f"error: the run loaded {', '.join(found)}", file=sys.stderr)
        shutil.rmtree(outdir, ignore_errors=True)
        return 3, None
    mem_peak = torch.cuda.max_memory_allocated(0) if require_device else 0
    dev = device_info(torch, chips) if require_device else \
        {"platform": "cpu", "kind": "cpu", "count": 0}
    dev["memory_peak_bytes"] = mem_peak

    if trace and prof is not None:
        path = os.path.join(outdir, "trace.json")
        prof.export_chrome_trace(path)
        tr = read_trace(path)
        os.remove(path)
        run.busy_s, merged = busy_union(tr["spans"])
        run.kernel_s = tr["kernel_s"]
        to_host = lambda us: (us + tr["to_epoch_us"]) / 1e6 - epoch_off
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = stage_spans(run.calls)
        run.gaps = [(stage_of(spans, to_host(a), to_host(b)), (b - a) / 1e6)
                    for a, b in gaps[:10]]
        dev["busy_s"] = run.busy_s
        dev["window_s"] = run.window_s
    del prof
    run.calls_done = len(run.calls) - failed

    # the last call's output is compared; the others were deleted as the
    # window went on, their sizes kept
    kept = entry.output(len(run.calls) - 1) if not failed else None
    run.work_per_call = entry.work(kept) if kept else 0.0
    run.alignments = entry.alignments()

    # the comparison, once the program's state is freed
    del entry
    gc.collect()
    if require_device:
        torch.cuda.empty_cache()
    sizes = [c["bytes"] for c in run.calls]
    checks: Dict[str, Tuple[float, float]] = {
        "calls_differing_in_size": (sum(b != sizes[-1] for b in sizes), 0)}
    t_check = time.perf_counter()
    if kept:
        ref_entry = entry_mod.Entry(cfg, cell["workload"], inputs, outdir)
        for name, v in ref_entry.check(kept, device).items():
            checks[name] = (v, 0)
    check_s = time.perf_counter() - t_check
    shutil.rmtree(outdir, ignore_errors=True)
    correct = bool(kept) and all(v <= lim for v, lim in checks.values())

    metrics: Dict[str, dict] = {}
    if not trace:
        for m in cell["end_to_end"]:
            v = end_to_end(m["name"], run, setup_s, peak_host, cfg)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["per_layer"]:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        top = sorted(run.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                               "idle_gaps": [[k, v] for k, v in run.gaps]}
    result["calls_s"] = [c["t1"] - c["t0"] for c in run.calls]
    result["calls_cpu_s"] = [c["cpu_s"] for c in run.calls]
    result["gc_s"] = gc_clock.seconds
    result["inputs_s"] = inputs_s
    result["check_s"] = check_s
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return 0, result


def end_to_end(name: str, run: Run, setup_s: float, peak_host: int,
               cfg: dict) -> Optional[float]:
    if name == "setup_s":
        return setup_s
    if name == "peak_host_gb":
        return peak_host / 1e9
    if name == cfg["rate_metric"]:
        return run.calls_done * run.work_per_call / run.window_s
    return None


def main(argv: List[str], t_start: float) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for var, sub in (("NPORE_TORCH_BUILD", "build"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    code, result = run_cell(load_cell(a.workload), a.seed, a.seconds,
                            bool(a.trace), t_start)
    if result is None:
        return code
    for k, c in result["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0
