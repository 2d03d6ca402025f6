"""Checks and costs of the port's tracer (``npore_tpu_torch.tracing``)
on the cell ``realign.wgs``, on the card (or, with ``--cpu``, a tiny
rehearsal of the cell with the ``torch`` engine).

    python3 benchmark/trace_check.py --out DIR [--seed N] [--phases 1234]

Each phase prints ``[tag] {json}`` lines and appends them to
``DIR/trace_check.jsonl``:

1. ``traced``, ``calls``: a traced window of the harness (``run_cell``
   with ``--trace 1``): its result line, and per call whether every span
   name is there under one call id, the main thread's self time in
   ``realign.call``, ``engine.collect`` summed against ``wait_s``, the
   engine's starved share and each span's ms; over the window each
   span's µs a kb written.
2. ``clock``: one CLI call with ``--profile_dir`` and ``NPORE_TIMING=1``;
   each group's block on the engine's stream (its H2D copy, K4, K1, K2,
   D2H) is matched to the group's ``engine.submit`` and
   ``engine.collect`` spans in order. A violation is a K4 that starts
   before its submit span starts, or a collect span that ends before its
   D2H copy ends; the largest is reported in µs (0 where none).
3. ``cost``: the ns of an empty span and of a counter call, tracing on
   and off (median of 5 loops of 200,000), times the spans and counter
   calls of one traced CLI call, over that call's wall time.
4. ``window``, ``windows``: windows of ``--seconds`` of back-to-back CLI
   calls (the harness's entry, no profiler) with ``NPORE_TIMING=1`` and
   without, in turns on, off, off, on; each side's median kb/s.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "benchmark", ".cache", "trace_check")


def say(tag, obj):
    print(f"[{tag}] " + json.dumps(obj), flush=True)
    with open(os.path.join(OUT, "trace_check.jsonl"), "a") as fh:
        fh.write(json.dumps({"tag": tag, **obj}) + "\n")


def main():
    global OUT
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seed", type=int, default=3700000001)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--windows", type=int, default=12)
    p.add_argument("--phases", default="1234")
    p.add_argument("--out", default=OUT)
    a = p.parse_args()
    OUT = a.out
    os.makedirs(OUT, exist_ok=True)
    from benchmark import harness
    for var, sub in (("NPORE_TORCH_BUILD", "build"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(harness.CACHE, sub)
    import torch
    from npore_tpu_torch import tracing
    kw = {}
    cell = harness.load_cell("realign.wgs")
    if a.cpu:
        from benchmark.tests.conftest import TINY
        cell["name"] = "test.tiny"
        cell["workload"]["traffic"]["layout"].update(TINY)
        kw = dict(engine="torch", require_device=False, device="cpu")
    else:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        say("card", {"card": power, "torch": torch.__version__})
    engine = kw.get("engine", "cuda")

    if "1" in a.phases:
        kept = []

        class Kept(harness.Run):
            def __init__(self, c):
                super().__init__(c)
                kept.append(self)
        harness.Run = Kept
        tracing.reset()
        code, res = harness.run_cell(cell, a.seed, a.seconds, True,
                                     time.perf_counter(), **kw)
        harness.Run = Kept.__bases__[0]
        run = kept[0]
        res.pop("checks", None)
        say("traced", {"code": code, "result": res})
        from benchmark import spans as bspans
        spans, counters = bspans.in_window(run)
        roots = sorted((s for s in spans if s.name == "realign.call"),
                       key=lambda s: s.t0)
        want = {"realign.call", "realign.fasta", "realign.region_count",
                "realign.tables", "realign.header", "realign.stage",
                "realign.engine_init", "realign.sam_write",
                "pipeline.decode", "pipeline.decode_wait",
                "pipeline.main_wait", "pipeline.stage_a",
                "pipeline.stage_b", "pipeline.finalize",
                "pipeline.sam_build", "regions.count", "engine.windows",
                "engine.submit", "engine.collect", "engine.golden"}
        per_call = []
        for r, c in zip(roots, run.calls):
            own = [s for s in spans if s.call == r.call]
            names = {s.name for s in own}
            kids = sum(s.t1 - s.t0 for s in own if s.parent == r.id)
            coll = sum(s.t1 - s.t0 for s in own
                       if s.name == "engine.collect") / 1e9
            ms = lambda n: sum(s.t1 - s.t0 for s in own  # noqa: E731
                               if s.name == n) / 1e6
            stage_ns, starved = bspans.starved_ns(own)
            per_call.append({
                "call_ms": (r.t1 - r.t0) / 1e6,
                "starved_share": starved / stage_ns,
                "missing": sorted(want - names), "n_spans": len(own),
                "self_share": 1 - kids / (r.t1 - r.t0),
                "collect_s": coll, "wait_s": c["counters"].get("wait_s"),
                "fasta_ms": ms("realign.fasta"),
                "region_count_ms": ms("realign.region_count"),
                "tables_ms": ms("realign.tables"),
                "header_ms": ms("realign.header"),
                "engine_init_ms": ms("realign.engine_init"),
                "stage_ms": ms("realign.stage"),
                "decode_ms": ms("pipeline.decode"),
                "decode_wait_ms": ms("pipeline.decode_wait"),
                "main_wait_ms": ms("pipeline.main_wait"),
                "sam_write_ms": ms("realign.sam_write"),
                "stage_a_ms": ms("pipeline.stage_a"),
                "stage_b_ms": ms("pipeline.stage_b"),
                "finalize_ms": ms("pipeline.finalize"),
                "sam_build_ms": ms("pipeline.sam_build"),
                "submit_ms": ms("engine.submit"),
                "windows_ms": ms("engine.windows"),
                "golden_ms": ms("engine.golden")})
        kb = run.calls_done * run.work_per_call
        us_per_kb = {}
        for s in spans:
            us_per_kb[s.name] = us_per_kb.get(s.name, 0) + (s.t1 - s.t0)
        # stage B less its event waits, the C++ finalize and the SAM
        # build: the engine's result decode, _finish and golden fallback
        stage_b = {s.id for s in spans if s.name == "pipeline.stage_b"}
        rest = sum((s.t1 - s.t0) * (1 if s.name == "pipeline.stage_b"
                                    else -1) for s in spans
                   if s.name == "pipeline.stage_b" or (
                       s.parent in stage_b and s.name in (
                           "engine.collect", "pipeline.finalize",
                           "pipeline.sam_build")))
        say("calls", {"n_calls": len(run.calls), "n_roots": len(roots),
                      "stage_b_rest_us_per_kb": rest / 1e3 / kb,
                      "us_per_kb": {k: v / 1e3 / kb
                                    for k, v in sorted(us_per_kb.items())},
                      "one_id_each": len({r.call for r in roots}) ==
                      len(roots), "per_call": per_call,
                      "counters": counters, "kb": kb})

    inputs = harness.inputs_for(cell, a.seed)
    cfg = harness.resolve(cell["config"])
    flags = list(cfg["cli"])
    flags[flags.index("--engine") + 1] = engine
    from npore_tpu_torch.cli import realign
    work = tempfile.mkdtemp(prefix="trace_proof_")

    def argv(pre, *more):
        return (["--bam", inputs["bam"], "--ref", inputs["fasta"],
                 "--out_prefix", os.path.join(work, pre)] + flags
                + list(more))

    if "2" in a.phases:
        prof = os.path.join(work, "prof")
        os.environ["NPORE_TIMING"] = "1"
        tracing.reset()
        realign.run(argv("w0"))          # warm
        realign.run(argv("p", "--profile_dir", prof))
        del os.environ["NPORE_TIMING"]
        with open(os.path.join(prof, "realign_trace.json")) as fh:
            ev = json.load(fh)["traceEvents"]
        sub = {e["args"]["group"]: e for e in ev if e.get("cat") == "npore"
               and e["name"] == "engine.submit"}
        col = {e["args"]["group"]: e for e in ev if e.get("cat") == "npore"
               and e["name"] == "engine.collect"}
        import shutil
        shutil.copy(os.path.join(prof, "realign_trace.json"),
                    os.path.join(OUT, "clock_trace.json"))
        dev = sorted((e for e in ev if e.get("cat") in
                      ("kernel", "gpu_memcpy", "gpu_memset")),
                     key=lambda e: e["ts"])
        k4_streams = {e["args"].get("stream") for e in dev
                      if "npinfo" in e["name"]}
        # the engine's stream: per group an H2D copy, K4, K1, K2, a D2H
        blocks = []
        for e in dev:
            if e["args"].get("stream") not in k4_streams:
                continue
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]:
                blocks.append({"h2d": e})
            elif blocks and "npinfo" in e["name"]:
                blocks[-1]["k4"] = e
            elif blocks and e.get("cat") == "gpu_memcpy" \
                    and "DtoH" in e["name"]:
                blocks[-1]["d2h"] = e
        groups = sorted(sub)
        viol_start, viol_end = [], []
        for g, blk in zip(groups, blocks):
            if "k4" in blk:
                viol_start.append(sub[g]["ts"] - blk["k4"]["ts"])
            if "d2h" in blk:
                d = blk["d2h"]
                viol_end.append(d["ts"] + d["dur"] - col[g]["ts"]
                                - col[g]["dur"])
        names = {}
        for e in dev:
            k = (e.get("cat"), e["name"][:40], e["args"].get("stream"))
            names[str(k)] = names.get(str(k), 0) + 1
        say("clock", {"groups": len(groups), "blocks": len(blocks),
                      "with_k4": sum("k4" in b for b in blocks),
                      "with_d2h": sum("d2h" in b for b in blocks),
                      "events": names,
                      "submit_before_k4_us": {
                          "max": max(viol_start, default=None),
                          "min": min(viol_start, default=None)},
                      "d2h_end_after_collect_end_us": {
                          "max": max(viol_end, default=None),
                          "min": min(viol_end, default=None)},
                      "largest_violation_us": max(
                          [0.0] + viol_start + viol_end)})

    if "3" in a.phases:
        def bench(n, fn):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            return (time.perf_counter_ns() - t0) / n

        def one_span():
            with tracing.span("x", batch=1):
                pass
        cost = {}
        for state in ("0", "1"):
            os.environ["NPORE_TIMING"] = state
            tracing.set_from_env()
            n = 200000
            cost[f"span_ns_{'on' if state == '1' else 'off'}"] = \
                statistics.median(bench(n, one_span) for _ in range(5))
            cost[f"count_ns_{'on' if state == '1' else 'off'}"] = \
                statistics.median(bench(n, lambda: tracing.count("y", 1))
                                  for _ in range(5))
            tracing.reset()
        os.environ["NPORE_TIMING"] = "1"
        calls = [0]
        real_count = tracing.count

        def counted(*args, **kwargs):
            calls[0] += 1
            return real_count(*args, **kwargs)
        tracing.count = counted
        tracing.reset()
        t0 = time.perf_counter()
        realign.run(argv("c"))
        wall = time.perf_counter() - t0
        tracing.count = real_count
        del os.environ["NPORE_TIMING"]
        n_spans = len(tracing.read()["spans"])
        tracing.reset()
        cost.update({"spans_a_call": n_spans, "counts_a_call": calls[0],
                     "call_s": wall})
        cost["on_ms_a_call"] = (n_spans * cost["span_ns_on"] + calls[0]
                                * cost["count_ns_on"]) / 1e6
        cost["off_ms_a_call"] = (n_spans * cost["span_ns_off"] + calls[0]
                                 * cost["count_ns_off"]) / 1e6
        cost["on_share_of_call"] = cost["on_ms_a_call"] / 1e3 / wall
        say("cost", cost)

    if "4" in a.phases:
        from benchmark.entries.realign import Entry
        ent = Entry(cfg, cell["workload"], inputs, work,
                    kw.get("engine"))
        ent.warm()
        kb = None
        order = ["on", "off", "off", "on"] * ((a.windows + 3) // 4)
        rates = {"on": [], "off": []}
        k = 0
        for side in order[:a.windows]:
            if side == "on":
                os.environ["NPORE_TIMING"] = "1"
            else:
                os.environ.pop("NPORE_TIMING", None)
            import gc
            gc.collect()
            w0 = time.perf_counter()
            n = 0
            while True:
                import contextlib
                import io
                with contextlib.redirect_stdout(io.StringIO()):
                    ent.call(k)
                n += 1
                if kb is None:
                    kb = ent.work(ent.output(k))
                ent.discard(k)
                k += 1
                if time.perf_counter() - w0 >= a.seconds:
                    break
            if not a.cpu:
                torch.cuda.synchronize()
            w = time.perf_counter() - w0
            rates[side].append(n * kb / w)
            tracing.reset()
            say("window", {"side": side, "calls": n, "window_s": w,
                           "kb_per_s": n * kb / w})
        os.environ.pop("NPORE_TIMING", None)
        say("windows", {"on_median": statistics.median(rates["on"]),
                        "off_median": statistics.median(rates["off"]),
                        "on": rates["on"], "off": rates["off"],
                        "kb_a_call": kb})


if __name__ == "__main__":
    main()
