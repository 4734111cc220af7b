"""Nestable wall-clock spans with trace-ID propagation and Chrome-trace export.

    with trace.span("map1", backend="pallas", n=4096):
        ...work...

Spans nest through a thread-local stack, so a callee's span becomes a
child of whatever span its caller currently holds — no plumbing of
context objects through APIs.  Completed spans land in the process-wide
``TRACER`` ring buffer; ``TRACER.write(path)`` emits Chrome-trace JSON
(load in ``chrome://tracing`` or https://ui.perfetto.dev).

Request IDs: ``with trace.request_trace() as tid:`` stamps every span
opened on this thread (including nested callee spans) with ``tid``;
a server opens one per request and returns the ID in its response, so a
client-reported ID selects the exact span subtree that served it.

``enable_profiler_annotations(True)`` additionally opens a
``torch.profiler.record_function`` range per span, so spans show up
inside device profiles.  It is off by default and costs nothing then.

Every closed span also feeds the ``repro_span_seconds{name=...}``
histogram on the metrics registry, which is how benchmarks consume
stage timings without re-deriving them.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, Iterator, List, Optional, Set, Tuple

from . import metrics as _metrics

__all__ = [
    "SpanRecord", "Tracer", "TRACER", "span", "request_trace",
    "current_trace_id", "new_trace_id", "enable_profiler_annotations",
    "chrome_coverage",
]

# Map perf_counter() readings onto the epoch so Chrome-trace timestamps
# are wall-clock anchored while durations keep perf_counter precision.
_EPOCH_OFFSET = time.time() - time.perf_counter()

_SPAN_SECONDS = _metrics.histogram(
    "repro_span_seconds", "wall-clock per completed span", ("name",))

_ids = itertools.count(1)
_tls = threading.local()

_annotate = False


def enable_profiler_annotations(on: bool = True) -> None:
    """Bridge spans into torch.profiler (off by default)."""
    global _annotate
    _annotate = bool(on)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace_id() -> Optional[str]:
    return getattr(_tls, "trace_id", None)


def _stack() -> List["SpanRecord"]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


class SpanRecord:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "t0", "t1", "tid")

    def __init__(self, name: str, attrs: Dict[str, object],
                 trace_id: Optional[str], parent_id: Optional[int]):
        self.name = name
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t1 = self.t0
        self.tid = threading.get_ident()

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_event(self) -> dict:
        args = {str(k): v for k, v in self.attrs.items()}
        args["span_id"] = self.span_id
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        if self.trace_id is not None:
            args["trace_id"] = self.trace_id
        return {
            "name": self.name,
            "ph": "X",
            "ts": (self.t0 + _EPOCH_OFFSET) * 1e6,
            "dur": max(self.duration, 1e-9) * 1e6,
            "pid": os.getpid(),
            "tid": self.tid,
            "args": args,
        }


class Tracer:
    """Bounded ring buffer of completed spans."""

    def __init__(self, max_spans: int = 65536):
        self.enabled = True
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._spans.append(rec)

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def chrome_trace(self) -> dict:
        events = [r.to_event() for r in self.spans()]
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


TRACER = Tracer()


@contextlib.contextmanager
def request_trace(trace_id: Optional[str] = None) -> Iterator[str]:
    """Set the thread's trace ID for the duration of the block."""
    prev = getattr(_tls, "trace_id", None)
    tid = trace_id or new_trace_id()
    _tls.trace_id = tid
    try:
        yield tid
    finally:
        _tls.trace_id = prev


@contextlib.contextmanager
def span(name: str, **attrs: object) -> Iterator[Optional[SpanRecord]]:
    """Open a nested span; yields the record (None when tracing is off)."""
    if not TRACER.enabled:
        yield None
        return
    stack = _stack()
    parent = stack[-1].span_id if stack else None
    rec = SpanRecord(name, attrs, current_trace_id(), parent)
    stack.append(rec)
    ann = None
    if _annotate:
        import torch
        ann = torch.profiler.record_function(name)
        ann.__enter__()
    try:
        yield rec
    finally:
        if ann is not None:
            ann.__exit__(None, None, None)
        rec.t1 = time.perf_counter()
        if stack and stack[-1] is rec:
            stack.pop()
        TRACER.record(rec)
        _SPAN_SECONDS.labels(name=name).observe(rec.duration)
        if not stack:
            from . import runtime as _runtime
            _runtime.maybe_sample()


def chrome_coverage(trace_obj: dict, root_name: str
                    ) -> Tuple[float, Set[str]]:
    """(fraction of root span covered by its children, child span names).

    Coverage is the summed duration of the root's *direct* children over
    the root's duration — the acceptance metric for "the span tree
    attributes the run's wall-clock to named stages".
    """
    events = trace_obj.get("traceEvents", [])
    roots = [e for e in events if e["name"] == root_name]
    if not roots:
        return 0.0, set()
    root = max(roots, key=lambda e: e["dur"])
    rid = root["args"]["span_id"]
    kids = [e for e in events if e["args"].get("parent_id") == rid]
    covered = sum(e["dur"] for e in kids)
    return covered / max(root["dur"], 1e-9), {e["name"] for e in kids}
