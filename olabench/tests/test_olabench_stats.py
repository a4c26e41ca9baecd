"""The end-to-end arithmetic: percentiles, the answer rate, and the queries
in flight at the window's close counted at their final latency or, never
answered, at their age."""

import numpy as np
import pytest

from harness import stats
from harness.loop import Answer


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 200, 201])
def test_percentile_matches_numpy_linear(q, n):
    xs = np.random.default_rng(n).exponential(size=n)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_empty_percentile_is_nan():
    assert np.isnan(stats.percentile([], 50))


def test_window_latencies_and_rate():
    A = Answer
    answers = [
        A(0, 0, 0, t_submit=0.0, t_answer=0.5),    # answered before: out
        A(1, 1, 0, t_submit=0.5, t_answer=2.0),    # in the window: 1.5
        A(2, 2, 0, t_submit=3.0, t_answer=4.0),    # in the window: 1.0
        A(3, 3, 0, t_submit=9.0, t_answer=12.0),   # in flight, answered: 3.0
        A(4, 4, 0, t_submit=8.0, t_answer=None),   # never: age at end, 7.0
        A(5, 5, 0, t_submit=11.0, t_answer=11.5),  # submitted after: out
    ]
    lat = stats.window_latencies(answers, t_open=1.0, t_close=10.0,
                                 t_end=15.0)
    assert sorted(lat) == [1.0, 1.5, 3.0, 7.0]
    e = stats.end_to_end(answers, 1.0, 10.0, 15.0)
    assert e["answers_per_s"] == pytest.approx(2 / 9.0)
    assert e["answer_p50_s"] == pytest.approx(2.25)
    assert e["answer_p95_s"] == pytest.approx(
        np.percentile([1.0, 1.5, 3.0, 7.0], 95))
    assert e["latency_samples"] == 4


def test_a_stall_shows_in_the_tail():
    quick = [Answer(i, i, 0, t_submit=1.0 + i * 0.01,
                    t_answer=1.1 + i * 0.01) for i in range(100)]
    stalled = [Answer(100 + i, i, 0, t_submit=5.0, t_answer=None)
               for i in range(10)]
    e = stats.end_to_end(quick + stalled, 0.0, 10.0, 70.0)
    assert e["answer_p95_s"] == pytest.approx(65.0)


def test_metric_readers_take_the_window_arithmetic():
    from harness import spec
    answers = [Answer(i, i, 0, t_submit=float(i), t_answer=float(i) + 2.0)
               for i in range(10)]
    e2e = stats.end_to_end(answers, 0.0, 20.0, 20.0)
    record = dict(e2e=e2e, setup_s=12.5, peak_bytes=3 * 2 ** 20)
    read = {n: spec.reader({"name": n}) for n in (
        "window_answers_per_s", "answer_p50_s", "answer_p95_s", "setup_s",
        "peak_device_mib")}
    assert read["window_answers_per_s"](record) == pytest.approx(0.5)
    assert read["answer_p50_s"](record) == pytest.approx(2.0)
    assert read["answer_p95_s"](record) == pytest.approx(2.0)
    assert read["setup_s"](record) == 12.5
    assert read["peak_device_mib"](record) == 3.0
    empty = dict(record, e2e=stats.end_to_end([], 0.0, 20.0, 20.0))
    assert read["answer_p50_s"](empty) is None
    assert read["answer_p95_s"](empty) is None
