"""One run of one cell: set-up, warm-up, the measured window, the traced
stretches, the wait for answers in flight, then the reference and the
check.

Set-up (timed from process start to the window's start) makes the table on
the device from the configuration's seed, in the record layout the run's
seed picks, hands it to the program as a ``ChunkStore`` (in memory, or as
raw chunk files in a fresh directory under ``TMPDIR``), builds the server
and runs the closed loop for the traffic's warm-up steps (a step: one
``server.step()``, a round unless every query was answered at admission):
every kernel and round variant the window uses has then run.  The window
runs the same loop for ``seconds``.  After it the run stops submitting and
waits for the queries in flight, up to the traffic's ``drain_s``.  Only
then is the device peak read, the program's state freed, and the reference
run over the table's bytes made again.

The table's values and the engine's sample come from the configuration's
seeds and the queries from the traffic's deck, the same in every run; the
run's seed lays out the record's columns (``harness/table.py``), so that
runs of different seeds do the same work on other bytes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import tempfile
import time

import torch

from harness import check, loop, program, stats, table
from harness import trace as tr
from reference import exact_aggregates


def _answer_row(a, deck) -> dict:
    row = program.answer_fields(a.result)
    row.update(spec=a.spec, epsilon=deck[a.spec]["epsilon"], qid=a.qid,
               t_submit=a.t_submit, t_answer=a.t_answer)
    return row


class _GcClock:
    """The seconds the interpreter's garbage collector took, as a
    ``gc.callbacks`` entry."""

    def __init__(self, clock):
        self.clock, self.seconds, self.runs, self._t = clock, 0.0, 0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = self.clock()
        else:
            self.seconds += self.clock() - self._t
            self.runs += 1


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False,
        window_steps: int | None = None, fault=None) -> dict:
    """One run of ``cell`` (a :class:`harness.spec.Cell`).  ``control``
    runs the configuration's control (its broken guarantee, with its
    server options) in place of what it states; ``window_steps`` ends the
    window after that many server steps instead of ``seconds`` (tests);
    ``fault`` is a context manager that breaks the program underneath for
    the whole run (tests)."""
    cfg, traffic = cell.config, cell.traffic
    gen = importlib.import_module(f"generators.{traffic['generator']}")
    deck = gen.deck(traffic, cfg)
    layout = table.column_order(seed, int(cfg["table"]["num_cols"]))
    specs = [table.place(q, layout) for q in deck]
    conf = cfg["control" if control else "guarantees"]["confidence"]
    server_opts = dict(cfg["server"],
                       **(cfg["control"].get("server", {}) if control
                          else {}))
    on_card = torch.device(device).type == "cuda"
    clock = time.perf_counter
    digests = []
    phases = {"start": clock() - t_start}
    with contextlib.ExitStack() as stack:
        if fault is not None:
            stack.enter_context(fault)
        if on_card:
            program.build_kernels()
        phases["kernels"] = clock() - t_start
        directory = None
        if cfg["store"] == "files":
            directory = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="olabench-"))
        store = program.new_store(cfg, directory)
        for raw in table.chunks(cfg["table"], device, layout):
            digests.append(table.digest(raw))
            store.append_chunk(raw.cpu().numpy(), num_tuples=raw.shape[0])
        store.finalize()
        if on_card:
            torch.cuda.synchronize(device)
            # the peak is the deployment's: the table's generation is not
            torch.cuda.reset_peak_memory_stats(device)
        phases["table"] = clock() - t_start
        tracer = tr.AnnotatingTracer() if trace else None
        server = stack.enter_context(program.make_server(
            dict(cfg, server=server_opts), store, device, tracer=tracer))
        _sync(device)
        phases["server"] = clock() - t_start
        sessions = loop.Sessions(
            server, lambda i: program.query(specs[i], conf),
            gen.order(len(deck)), int(traffic["analysts"]))
        sessions.start()
        warm = iter(range(int(traffic["warmup_steps"])))
        sessions.run_until(lambda: next(warm, None) is None)
        _sync(device)

        t_open = clock()
        phases["warmup"] = t_open - t_start
        setup_s = t_open - t_start
        rounds_open = server.rounds
        collector = _GcClock(clock)
        gc.callbacks.append(collector)
        if window_steps is not None:
            steps = iter(range(window_steps))
            sessions.run_until(lambda: next(steps, None) is None)
        else:
            sessions.run_until(lambda: clock() - t_open >= seconds)
        t_close = clock()
        gc.callbacks.remove(collector)
        rounds_window = server.rounds - rounds_open

        profile = aten = None
        if trace:
            profile = tr.profile_stretch(sessions, tracer,
                                         tr.PROFILE_ROUNDS, device)
            aten = tr.aten_stretch(sessions, tr.ATEN_ROUNDS)
        sessions.submitting = False
        t_drain = clock()
        sessions.run_until(lambda: not sessions.outstanding
                           or clock() - t_drain >= float(traffic["drain_s"]))
        t_end = clock()
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0

        queries = sessions.answers + list(sessions.outstanding.values())
        e2e = stats.end_to_end(queries, t_open, t_close, t_end)
        rows = [_answer_row(a, deck) for a in sessions.answers]
        in_window = [r for r in rows if t_open < r["t_answer"] <= t_close]
        outstanding = len(sessions.outstanding)
        spans = tracer.spans_between(t_open, t_close) if trace else []
        shape = dict(w=server.config.num_workers, c=store.codec.num_cols,
                     s=server.max_slots, cap=server.config.cache_cap,
                     packed=server.config.residency == "packed")
        rounds_total = server.rounds
        del server, sessions, store
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    served = sorted({r["spec"] for r in rows})
    exact = dict(zip(served, exact_aggregates.exact_answers(
        _same_bytes(cfg["table"], device, digests, layout),
        [specs[i] for i in served], int(cfg["table"]["num_cols"]))))
    verdict = check.judge(rows, exact, outstanding, cfg["check"])
    window = dict(seconds=t_close - t_open, rounds=rounds_window,
                  answers=len(in_window),
                  rounds_total=rounds_total,
                  latency_samples=e2e["latency_samples"],
                  gc_s=collector.seconds, gc_runs=collector.runs,
                  answers_from_rounds=sum(not r["from_synopsis"]
                                          for r in rows),
                  answers_at_admission=sum(r["from_synopsis"]
                                           for r in rows))
    return dict(
        peak_bytes=peak, verdict=verdict,
        attempted=len(rows) + outstanding, window=window,
        setup_phases=phases,
        record=dict(e2e=e2e, setup_s=setup_s, peak_bytes=peak,
                    window=window,
                    answers=in_window, spans=spans, profile=profile,
                    aten=aten, shape=shape,
                    kind=(torch.cuda.get_device_name(device) if on_card
                          else "cpu")))


def _same_bytes(table_cfg: dict, device, digests: list, layout):
    """The table's chunks made again, each checked against the digest
    taken when the program was handed it."""
    for j, raw in enumerate(table.chunks(table_cfg, device, layout)):
        if table.digest(raw) != digests[j]:
            raise RuntimeError(f"chunk {j} made again differs from the "
                               "bytes the program was given")
        yield raw
