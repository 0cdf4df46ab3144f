"""Spans: where a request's time goes inside the daemon, on one clock.

A span is one named stretch of a thread's work: its start and end on
`time.monotonic_ns()` (CLOCK_MONOTONIC, the clock a profiler's device
events are mapped onto, so that spans and kernels line up), the thread's
CPU nanoseconds inside it (`time.thread_time_ns()`), the trace it belongs
to (one an HTTP request: its `X-Request-ID`, else a number of the
process), its own id, its parent's (the span open where it started: in
this thread's context, or in the context handed over with the work), the
thread, and a few attributes. Counters and timers that aggregate live in
`utils/metrics.py`; this module holds only spans.

Tracing is off until `start()` and off again after `stop()`; nothing
else switches it (the daemon's `POST /dbg/trace/start|stop` call them).
While it is off a span site costs a read of `active` and a branch:
`span()` hands back one shared no-op context manager, and a `stage()`
only adds its wall seconds to its stats key, as it always does. While it
is on, finished spans go to a ring of `capacity` spans; past that the
oldest go, counted by `dropped()`.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 1 << 20

active = False          # read at every span site
_ring: Optional[collections.deque] = None
_epoch = 0              # numbers each start()
_finished = itertools.count()   # spans kept since start()
_dropped = 0            # spans the ring let go, as of the last stop()
_lock = threading.Lock()        # start() and stop()
_current: contextvars.ContextVar = contextvars.ContextVar(
    "aresdb_tpu_torch_span", default=None)
_span_ids = itertools.count(1)
_trace_ids = itertools.count(1)

# A finished span, as stop() hands it back. The ring keeps each as one flat
# tuple of plain values, its attributes' keys and values last, which the
# garbage collector stops tracking at its next pass (it tracks a named
# tuple, or a tuple that holds a dict, for good): a full ring would
# otherwise lengthen and multiply its full passes, each a pause of every
# thread.
Finished = collections.namedtuple(
    "Finished", "name trace id parent thread start end cpu attrs")


class Span:
    """One span. As a context manager it is the current span of its
    context from enter to exit; `begin()`/`finish()` time one that starts
    on one thread and ends on another (it is never current, and has no
    CPU time)."""

    __slots__ = ("name", "trace", "id", "parent", "thread", "start", "end",
                 "cpu", "attrs", "_epoch", "_cpu0", "_token")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.cpu = None

    def _open(self, current: bool) -> "Span":
        parent = _current.get()
        if parent is not None:
            self.trace, self.parent = parent.trace, parent.id
        else:
            self.trace = str(next(_trace_ids))
            self.parent = None
        self.id = next(_span_ids)
        self._epoch = _epoch
        # get_ident, not get_native_id: the native id is a system call at
        # each read, microseconds with the GIL held where system calls are
        # slow (a user-space kernel such as gVisor)
        self.thread = threading.get_ident()
        self._token = _current.set(self) if current else None
        self._cpu0 = time.thread_time_ns() if current else None
        self.start = time.monotonic_ns()
        return self

    def _close(self, end: Optional[int] = None) -> None:
        self.end = time.monotonic_ns() if end is None else end
        if self._token is not None:
            self.cpu = time.thread_time_ns() - self._cpu0
            _current.reset(self._token)
        _keep(self)

    def __enter__(self) -> "Span":
        return self._open(True)

    def __exit__(self, *exc) -> None:
        self._close()


class _Off:
    """The context manager of every span site while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Stage:
    """A stats key's timer: adds its wall seconds to `stats[name]` at
    each exit and, while tracing, records a span of the same name. One
    object may time many entries in turn (a query's batches)."""

    __slots__ = ("stats", "name", "t0", "span")

    def __init__(self, stats: Dict, name: str):
        self.stats = stats
        self.name = name
        self.span = None

    def __enter__(self) -> Optional[Span]:
        if active:
            self.span = Span(self.name, {})._open(True)
            self.t0 = self.span.start
            return self.span
        self.t0 = time.monotonic_ns()
        return None

    def __exit__(self, *exc) -> None:
        t1 = time.monotonic_ns()
        self.stats[self.name] = self.stats.get(self.name, 0.0) + (
            t1 - self.t0) / 1e9
        if self.span is not None:
            span, self.span = self.span, None
            span._close(t1)


def _keep(span: Span) -> None:
    """Keep a finished span, where the tracing it started under is still
    on. Takes no lock: a deque's append and a count's step are atomic
    under the interpreter lock, and a lock that a thread waits on here
    would hand the interpreter lock to another at every span."""
    ring = _ring
    if ring is not None and span._epoch == _epoch:
        kept = (span.name, span.trace, span.id, span.parent, span.thread,
                span.start, span.end, span.cpu)
        if span.attrs:
            kept += tuple(itertools.chain.from_iterable(span.attrs.items()))
        ring.append(kept)
        next(_finished)


def start(capacity: int = DEFAULT_CAPACITY) -> None:
    """Record spans from now on, the newest `capacity` of them. Raises
    where tracing is on already."""
    global active, _ring, _finished, _epoch
    if capacity < 1:
        raise ValueError(f"capacity must be positive, not {capacity}")
    with _lock:
        if active:
            raise RuntimeError("tracing has already been started")
        _ring = collections.deque(maxlen=capacity)
        _finished = itertools.count()
        _epoch += 1
        active = True


def stop() -> List[Finished]:
    """Stop recording; the spans kept, oldest first. Raises where tracing
    is off."""
    global active, _ring, _dropped
    with _lock:
        if not active:
            raise RuntimeError("tracing has not been started")
        active = False
        ring, _ring = _ring, None
        _dropped = max(0, next(_finished) - ring.maxlen)
        return [Finished(*t[:8], dict(zip(t[8::2], t[9::2])))
                for t in ring]


def dropped() -> int:
    """The spans that the ring let go between the last start() and
    stop()."""
    return _dropped


def span(name: str, **attrs):
    """A context manager that records a span `name` while tracing, and
    enters as that Span (as None while tracing is off). A span with none
    open above it starts a trace, numbered in the process; its `trace`
    may be set to another id before a span opens below it."""
    if not active:
        return _OFF
    return Span(name, attrs)


def stage(stats: Dict, name: str) -> _Stage:
    """A context manager that adds its wall seconds to stats[name] (a
    plan's `plan.stats`), and records a span `name` while tracing; it
    enters as that Span, or None. Reusable: make one before a loop."""
    return _Stage(stats, name)


def begin(name: str) -> Optional[Span]:
    """A span started here and ended by finish() on any thread (a wait in
    a queue); None while tracing is off."""
    if not active:
        return None
    return Span(name, {})._open(False)


def finish(span: Optional[Span]) -> None:
    """End a span that begin() started (nothing for None)."""
    if span is not None:
        span._close()


def note(**attrs) -> None:
    """Set attributes of the current span (call where `active` holds)."""
    span = _current.get()
    if span is not None:
        span.attrs.update(attrs)


def add(key: str, n: int = 1) -> None:
    """Add n to the current span's count `key` (call where `active`
    holds)."""
    span = _current.get()
    if span is not None:
        span.attrs[key] = span.attrs.get(key, 0) + n


def chrome_trace(spans: List[Finished], n_dropped: int = 0) -> Dict:
    """The spans as Chrome trace JSON: complete ("X") events, `ts` and
    `dur` in microseconds of CLOCK_MONOTONIC, one row a thread; trace,
    span and parent ids, CPU microseconds and attributes in `args`."""
    pid = os.getpid()
    events = []
    for s in spans:
        args = {"trace": s.trace, "span": s.id, "parent": s.parent}
        if s.cpu is not None:
            args["cpu_us"] = s.cpu / 1e3
        args.update(s.attrs)
        events.append({"name": s.name, "cat": "aresdb", "ph": "X",
                       "ts": s.start / 1e3, "dur": (s.end - s.start) / 1e3,
                       "pid": pid, "tid": s.thread, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock": "CLOCK_MONOTONIC",
                          "droppedSpans": n_dropped}}


def write_chrome_trace(spans: List[Finished], directory: str,
                       n_dropped: int = 0) -> str:
    """chrome_trace(spans) as a file `spans-<time>.json` in directory
    (made where missing); its path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory,
                        f"spans-{time.strftime('%Y%m%d-%H%M%S')}.json")
    with open(path, "w") as f:
        json.dump(chrome_trace(spans, n_dropped), f, default=str)
    return path
