"""What the traced run (``--trace 1``) reads beside the window: the
program's own spans, a stretch of rounds under ``torch.profiler``, and a
stretch of rounds under an aten-op counter.

The spans come from the program's tracer (``obs/trace.py::SpanTracer``,
passed as ``ServerOptions.tracer``).  During the profiled stretch each span
is also a ``record_function`` range, so the profile can say which span the
host was in while the device sat idle.  The profiler's own processing is
slow (seconds for a few thousand launches), so it covers a fixed, small
number of rounds.
"""

from __future__ import annotations

import contextlib
import time

import torch

from harness.program import SpanTracer

#: rounds under the profiler and under the aten-op counter
PROFILE_ROUNDS = 25
ATEN_ROUNDS = 20
#: the program spans an idle gap is attributed to, innermost first
SPANS = ("claims", "kernel", "merge", "estimate", "round")


class AnnotatingTracer(SpanTracer):
    """The program's span tracer; with ``annotate`` on, each span of
    :data:`SPANS` is also a profiler range of the same name."""

    annotate = False

    def __init__(self):
        self.origin = time.perf_counter()
        super().__init__(clock=time.perf_counter)

    def span(self, name: str, **args):
        sp = super().span(name, **args)
        if not self.annotate or name not in SPANS:
            return sp
        stack = contextlib.ExitStack()
        stack.enter_context(torch.profiler.record_function(name))
        stack.enter_context(sp)
        return stack

    def spans_between(self, t0: float, t1: float) -> list[tuple]:
        """``(name, start, duration, args)`` of the spans that started in
        ``[t0, t1)`` on the server's thread, times in perf_counter s."""
        out = []
        for name, ts, dur, tid, depth, args in list(self.events):
            start = self.origin + ts
            if tid == 0 and t0 <= start < t1 and dur > 0:
                out.append((name, start, dur, args))
        return out


def count_aten_ops(fn) -> int:
    """The aten operators ``fn()`` dispatches (views included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _union(intervals: list[tuple]) -> list[list]:
    merged: list[list] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profile_stretch(sessions, tracer: AnnotatingTracer, rounds: int,
                    device) -> dict:
    """``rounds`` rounds of the closed loop under ``torch.profiler``:
    device busy seconds (the union of every device operation's interval),
    the stretch's wall seconds, device seconds and launches by operation,
    idle gaps by the program span the host was in, and the rounds' (B,
    mode) as the program's ``kernel`` span recorded them."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
        lambda: None)
    sync()
    tracer.annotate = True
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        done = 0
        while done < rounds:
            done += bool(sessions.step())
        sync()
        t1 = time.perf_counter()
    tracer.annotate = False
    events = prof.events()
    dev, host = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # an annotation also shows as a device-side range: a span, not
            # device work
            if e.name not in SPANS:
                dev.append(e)
        elif e.name in SPANS:
            host.append(e)
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    by_op: dict[str, list] = {}
    for e in dev:
        rec = by_op.setdefault(e.name, [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) * 1e-6
        rec[1] += 1
    gaps: dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        inside = [e for e in host
                  if e.time_range.start <= mid < e.time_range.end]
        name = (min(inside, key=lambda e: e.time_range.end
                    - e.time_range.start).name if inside
                else "outside the round")
        gaps[name] = gaps.get(name, 0.0) + (start - end) * 1e-6
    kernel_args = [args for name, _, _, args in
                   tracer.spans_between(t0, t1) if name == "kernel"]
    return dict(rounds=done, wall_s=t1 - t0, busy_s=busy_us * 1e-6,
                ops={k: tuple(v) for k, v in by_op.items()},
                idle_gaps=gaps, kernel_args=kernel_args)


def aten_stretch(sessions, rounds: int) -> dict:
    """Aten ops the closed loop dispatches over ``rounds`` rounds."""
    done = [0]

    def run():
        while done[0] < rounds:
            done[0] += bool(sessions.step())

    ops = count_aten_ops(run)
    return dict(ops=ops, rounds=done[0])
