"""Nested span tracer with chrome-trace (Perfetto) export — zero deps.

The OLA query lifecycle is a pipeline the user is supposed to *watch*:
submit → admission decision → per-round (claims, kernel, merge, estimate)
→ retire, with the scan plane's READ / prefetch overlap running underneath
on the reader thread.  :class:`SpanTracer` records that shape as nested
spans and exports the standard chrome-trace JSON (``traceEvents`` with
complete ``"X"`` events), which https://ui.perfetto.dev or
``chrome://tracing`` open directly.

Design constraints, in order:

* **host-side only** — span boundaries wrap host calls (slab assembly, the
  jitted round dispatch, report reads); nothing jit-visible changes, so a
  traced run is round-for-round bit-exact with an untraced one;
* **allocation-light off** — the off state is :data:`NULL_TRACER`, whose
  ``span()`` returns one shared no-op context manager: the cost of
  disabled tracing is a method call, not an object graph;
* **deterministic in tests** — the clock is injected (``clock=`` any
  zero-arg callable returning seconds); a counter clock makes every
  timestamp and duration reproducible;
* **thread-safe** — the prefetcher's reader thread emits READ spans
  concurrently with the server loop; events carry a small per-thread tid
  and appends are lock-protected.  Span *nesting* state is thread-local,
  so cross-thread interleavings can never corrupt a stack;
* **bounded** — at ``max_events`` the tracer stops recording and counts
  drops (``dropped``) instead of growing without bound; the exporter
  stamps the drop count into the trace metadata rather than truncating
  silently.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional


class _NullSpan:
    """Shared no-op context manager: the entire cost of disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: every call is a no-op returning shared objects."""

    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def event(self, name: str, **args) -> None:
        return None


#: Module-level singleton — engines and pipelines default their ``tracer``
#: attribute to this so call sites never need a None check.
NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0", "depth")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.depth = len(stack)
        stack.append(self)
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc):
        tr = self.tracer
        t1 = tr.clock()
        tr._stack().pop()
        tr._record(self.name, self.t0, t1 - self.t0, self.depth, self.args)
        return False


class SpanTracer:
    """Span recorder (see module docstring).

    ``clock`` must be monotone (defaults to :func:`time.perf_counter`);
    timestamps are recorded relative to the tracer's construction so the
    exported trace starts near zero.
    """

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: int = 1_000_000):
        self.clock = clock if clock is not None else time.perf_counter
        self.max_events = int(max_events)
        self.events: list[tuple] = []   # (name, ts, dur, tid, depth, args)
        self.dropped = 0
        self._t0 = self.clock()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: dict[int, int] = {}   # thread ident -> small stable tid

    # ------------------------------------------------------------ record ----
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
        return tid

    def _record(self, name: str, t0: float, dur: float, depth: int,
                args: dict) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(
                (name, t0 - self._t0, max(dur, 0.0), self._tid(), depth,
                 args))

    def span(self, name: str, **args) -> _Span:
        """Context manager timing a nested span; ``args`` become the
        event's chrome-trace args payload (keep them small scalars)."""
        return _Span(self, name, args)

    def event(self, name: str, **args) -> None:
        """Instantaneous event (duration 0) at the current clock."""
        self._record(name, self.clock(), 0.0, len(self._stack()), args)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0
            self._t0 = self.clock()

    # ------------------------------------------------------------ export ----
    def to_chrome_trace(self, process_name: str = "ola-server") -> dict:
        """Chrome-trace JSON object: complete ``"X"`` events in
        microseconds, one chrome 'thread' per real thread (tid 0 is the
        server loop, higher tids are reader threads)."""
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
            tids = dict(self._tids)
        out = [{
            "name": "process_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": process_name},
        }]
        for ident, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            out.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": "server-loop" if tid == 0
                         else f"reader-{tid}"},
            })
        for name, ts, dur, tid, depth, args in events:
            ev = {"name": name, "ph": "X", "pid": 0, "tid": tid,
                  "ts": ts * 1e6, "dur": dur * 1e6, "cat": "ola"}
            if args or depth:
                ev["args"] = dict(args, depth=depth) if depth else dict(args)
            out.append(ev)
        doc = {"traceEvents": out, "displayTimeUnit": "ms"}
        if dropped:
            doc["otherData"] = {"dropped_events": dropped}
        return doc

    def save(self, path: str, process_name: str = "ola-server") -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(process_name), f)


def validate_chrome_trace(doc: dict) -> list[str]:
    """Schema/consistency check for an exported chrome trace; returns the
    list of problems (empty = valid).  Checks: ``traceEvents`` is a list
    of well-formed events, durations are non-negative and finite, and the
    ``"X"`` spans of each (pid, tid) nest properly — every span is either
    disjoint from or fully contained in any span it overlaps (the
    invariant a stack-shaped tracer must produce).  The CI observability
    smoke step runs this over the workload bench's trace."""
    problems: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    spans: dict[tuple, list] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"event {i}: missing name")
        if ph not in ("X", "M", "B", "E", "i", "I"):
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph != "X":
            continue
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or ts != ts:
            problems.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
            continue
        if (not isinstance(dur, (int, float)) or dur != dur
                or dur < 0 or dur == float("inf")):
            problems.append(
                f"event {i} ({ev.get('name')}): bad duration {dur!r}")
            continue
        spans.setdefault((ev.get("pid", 0), ev.get("tid", 0)), []).append(
            (float(ts), float(ts) + float(dur), ev.get("name", "")))
    for key, ss in spans.items():
        # sort by start asc, end desc: a parent sorts before its children
        ss.sort(key=lambda s: (s[0], -s[1]))
        stack: list = []
        for t0, t1, name in ss:
            while stack and t0 >= stack[-1][1]:
                stack.pop()
            if stack and t1 > stack[-1][1] + 1e-9:
                problems.append(
                    f"tid {key}: span {name!r} [{t0}, {t1}] overlaps "
                    f"{stack[-1][2]!r} [{stack[-1][0]}, {stack[-1][1]}] "
                    "without nesting")
                continue
            stack.append((t0, t1, name))
    return problems
