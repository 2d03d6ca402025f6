"""The port's own spans and counters, kept in memory.

The tracer is on exactly when ``NPORE_TIMING=1``. The entries that read
the variable (``cli.realign.run``, ``Realigner.realign_records``,
``cli.standardize_vcf.run``) call ``set_from_env()`` once at their start.
Off, ``span()`` returns one shared no-op context manager and ``count()``
and ``record()`` return at once: nothing is stamped or kept.

A span records its name, the native id of its thread, its start and end
(``time.perf_counter_ns()``, the clock of ``time.perf_counter``), its
parent span, the call it belongs to, and a batch or group index where
one applies. A span opened on a thread with no open span and no
``parent`` starts a new call. Work handed to another thread is traced
under ``parent=context()`` taken on the thread that handed it over, so
the spans of one CLI call share its call id across the pipeline's
threads; a batch's spans on each thread carry the same batch index.

Spans are per call, per contig, per batch or per group, never per record
or window. ``read()`` returns what was recorded, ``reset()`` clears it,
and ``add_to_chrome_trace`` writes the spans into a ``torch.profiler``
chrome trace on the profiler's timeline.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
from time import perf_counter_ns
from typing import Dict, List, NamedTuple, Optional, Tuple


class Span(NamedTuple):
    id: int
    name: str
    tid: int
    t0: int                 # perf_counter_ns
    t1: int
    parent: Optional[int]   # the parent span's id; None for a call's root
    call: int
    batch: Optional[int]
    group: Optional[int]


class Context(NamedTuple):
    """Where a span opened elsewhere belongs: a call and a parent span."""
    call: int
    span: Optional[int]


_on = False
_spans: List[Span] = []
_counters: Dict[Tuple[int, str], int] = {}
_threads: Dict[int, str] = {}
_lock = threading.Lock()            # _counters' read-modify-write
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_local = threading.local()


def set_from_env() -> bool:
    """Turns the tracer on or off from ``NPORE_TIMING``; returns whether
    it is on."""
    global _on
    _on = os.environ.get("NPORE_TIMING") == "1"
    return _on


def _stack() -> list:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.tid = threading.get_native_id()
        _threads[_local.tid] = threading.current_thread().name
        return _local.stack


def _here(parent: Optional[Context]) -> Context:
    """The given parent, else this thread's innermost open span, else a
    new call."""
    if parent is not None:
        return parent
    stack = _stack()
    if stack:
        return stack[-1].context
    return Context(next(_call_ids), None)


def context() -> Optional[Context]:
    """The context a span opened here now would have as its parent (a
    new call where no span is open), to hand to another thread; None
    when the tracer is off."""
    if not _on:
        return None
    return _here(None)


class _Open:
    __slots__ = ("name", "batch", "group", "parent", "context", "t0")

    def __init__(self, name, batch, group, parent):
        self.name, self.batch, self.group = name, batch, group
        self.parent = parent

    def __enter__(self):
        ctx = _here(self.parent)
        self.parent = ctx
        self.context = Context(ctx.call, next(_span_ids))
        _stack().append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        _stack().pop()
        _spans.append(Span(self.context.span, self.name, _local.tid,
                           self.t0, t1, self.parent.span,
                           self.context.call, self.batch, self.group))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, batch: Optional[int] = None,
         group: Optional[int] = None, parent: Optional[Context] = None):
    """A context manager that records the span ``name`` around its body."""
    if not _on:
        return _OFF
    return _Open(name, batch, group, parent)


def record(name: str, t0: int, t1: int, batch: Optional[int] = None,
           group: Optional[int] = None,
           parent: Optional[Context] = None) -> None:
    """Records a span timed by the caller (``perf_counter_ns`` values)."""
    if not _on:
        return
    ctx = _here(parent)
    _stack()
    _spans.append(Span(next(_span_ids), name, _local.tid, t0, t1,
                       ctx.span, ctx.call, batch, group))


def count(name: str, value: int = 1,
          parent: Optional[Context] = None) -> None:
    """Adds ``value`` to the counter ``name`` of the current call."""
    if not _on:
        return
    key = (_here(parent).call, name)
    with _lock:
        _counters[key] = _counters.get(key, 0) + value


def read() -> dict:
    """What was recorded: ``spans`` (``Span``s in the order they ended),
    ``counters`` ({(call, name): total}) and ``threads`` ({tid: name})."""
    with _lock:
        counters = dict(_counters)
    return {"spans": list(_spans), "counters": counters,
            "threads": dict(_threads)}


def reset() -> None:
    """Forgets every span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()


def totals(call: int, since: int = 0) -> Dict[str, int]:
    """Nanoseconds by span name of ``call``'s spans that started at or
    after ``since``."""
    out: Dict[str, int] = {}
    for s in list(_spans):
        if s.call == call and s.t0 >= since:
            out[s.name] = out.get(s.name, 0) + s.t1 - s.t0
    return out


def add_to_chrome_trace(path: str, clock: Tuple[int, int]) -> None:
    """Adds the spans that started since ``clock`` to the chrome trace at
    ``path`` (made if missing), one row a thread under this process.
    ``clock``: a (``time.time_ns()``, ``perf_counter_ns()``) pair taken
    together, which puts the spans on the trace's timeline (µs after its
    ``baseTimeNanoseconds``, as ``torch.profiler`` writes it)."""
    doc = {"traceEvents": []}
    if os.path.exists(path):
        with open(path) as fh:
            doc = json.load(fh)
    shift = clock[0] - clock[1] - doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    spans = [s for s in list(_spans) if s.t0 >= clock[1]]
    for s in spans:
        args = {"call": s.call, "id": s.id, "parent": s.parent}
        if s.batch is not None:
            args["batch"] = s.batch
        if s.group is not None:
            args["group"] = s.group
        events.append({"ph": "X", "cat": "npore", "name": s.name,
                       "pid": pid, "tid": s.tid, "ts": (s.t0 + shift) / 1e3,
                       "dur": (s.t1 - s.t0) / 1e3, "args": args})
    for tid in sorted({s.tid for s in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": _threads.get(tid, "")}})
    with open(path, "w") as fh:
        json.dump(doc, fh)
