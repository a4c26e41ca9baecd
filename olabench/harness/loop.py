"""The closed loop of analysts around the server's ``submit()`` and
``step()``.

Each analyst has one query outstanding.  Right after a ``step()`` returns
an analyst's answer, that analyst's next query is submitted, before the
next ``step()``: the loop is driven by rounds, not by a timer, so for a
given seed the sequence of queries, rounds and answers is the same on any
host and only how much of it fits in a window depends on speed.  A query's
latency is wall time from its ``submit()`` to the return of the ``step()``
that put its answer in ``server.results``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional


@dataclasses.dataclass
class Answer:
    qid: int
    analyst: int
    spec: int                 # deck position of the query
    t_submit: float
    t_answer: Optional[float] = None
    result: object = None     # the server's WorkloadResult


class Sessions:
    def __init__(self, server, make_query: Callable[[int], object],
                 order: Iterator[int], analysts: int):
        self.server = server
        self.make_query = make_query
        self.order = order
        self.analysts = int(analysts)
        self.clock = time.perf_counter
        self.outstanding: dict[int, Answer] = {}
        self.answers: list[Answer] = []
        self.submitting = True
        self._seen = 0

    def submit(self, analyst: int) -> None:
        spec = next(self.order)
        qid = self.server.submit(self.make_query(spec))
        self.outstanding[qid] = Answer(qid, analyst, spec, self.clock())

    def start(self) -> None:
        for a in range(self.analysts):
            self.submit(a)

    def step(self) -> bool:
        """One ``server.step()``; collects the answers it delivered and
        submits each answering analyst's next query.  Returns whether the
        server ran a round."""
        stepped = self.server.step()
        now = self.clock()
        new = self.server.results[self._seen:]
        self._seen = len(self.server.results)
        if not stepped and not new and self.outstanding:
            raise RuntimeError("the server idles with queries outstanding")
        answered = []
        for r in new:
            a = self.outstanding.pop(r.qid)
            a.t_answer, a.result = now, r
            self.answers.append(a)
            answered.append(a.analyst)
        if self.submitting:
            for analyst in answered:
                self.submit(analyst)
        return stepped

    def run_until(self, done: Callable[[], bool]) -> int:
        """Step until ``done()``; returns the rounds run."""
        rounds = 0
        while not done():
            rounds += bool(self.step())
        return rounds
