"""The check that decides ``correct``: a sound run passes it, and the
control and each fault the cells can have fail it.  Each drives a whole
run on the CPU at a small size, with the look for a card skipped; the
faults break the program underneath the timed path.  (The cells run on
one chip: no exchange between chips to leave out.)"""

import time
from unittest import mock

import numpy as np
import pytest
import torch

from harness import cell as cell_run
from harness import check, spec
from repro_torch.core.engine import SlotOLAEngine
from repro_torch.kernels import ops

STEPS = 300


def small_cell(config="zipf16-packed"):
    """The adhoc traffic on a configuration, at a small size."""
    cell = spec.cell(spec.load(), "zipf16-packed.adhoc")
    cell.config = spec.read_config(config)
    cell.config["table"].update(num_tuples=32 * 16384, num_chunks=32)
    cell.traffic.update(drain_s=20, warmup_steps=20)
    return cell


def drive(fault=None, control=False, seed=17, config="zipf16-packed",
          whole=False):
    torch.set_num_threads(2)
    res = cell_run.run(small_cell(config), seed, 0.0, False, "cpu",
                       time.perf_counter(), control=control,
                       window_steps=STEPS, fault=fault)
    return res if whole else res["verdict"]


def _round_fn_wrapping(change):
    orig = SlotOLAEngine.round_fn

    def round_fn(self, b, mode="none"):
        step = orig(self, b, mode)

        def broken(state, table, data, speeds):
            new, rep = step(state, table, data, speeds)
            return change(state, new, rep)
        return broken
    return mock.patch.object(SlotOLAEngine, "round_fn", round_fn)


def state_unchanged():
    return _round_fn_wrapping(lambda old, new, rep: (old, rep))


def answer_altered():
    def scale(old, new, rep):
        return new, rep._replace(estimate=rep.estimate * 1.5,
                                 lo=rep.lo * 1.5, hi=rep.hi * 1.5)
    return _round_fn_wrapping(scale)


def half_batch_left_out():
    """The kernel sums the first half of each worker's window, while the
    round counts every tuple of it as sampled."""
    orig = ops.slot_extract

    def half(packed, jw, idx, b_eff, *args, **kw):
        return orig(packed, jw, idx, torch.as_tensor(b_eff) // 2, *args,
                    **kw)
    return mock.patch.object(ops, "slot_extract", half)


def test_sound_run_is_correct():
    v = drive()
    assert v["correct"], v
    assert v["judged"] > 20
    assert v["numbers"]["off_4hw_pct"]["value"] < 5.0


def test_sound_files_run_is_correct():
    v = drive(config="zipf16-files", seed=18)
    assert v["correct"], v


def test_control_is_not_correct():
    res = drive(control=True, whole=True)
    v = res["verdict"]
    assert not v["correct"]
    assert v["numbers"]["off_4hw_pct"]["value"] > 3 * 5.0
    # its answers come from scan rounds: the round's interval is what fails
    assert res["window"]["answers_at_admission"] == 0
    assert res["window"]["answers_from_rounds"] == v["judged"]


@pytest.mark.parametrize("fault", [state_unchanged, half_batch_left_out,
                                   answer_altered])
def test_fault_is_not_correct(fault):
    v = drive(fault=fault())
    assert not v["correct"], v


def test_judge_counts_what_each_answer_says():
    def a(est, lo, hi, eps=0.05, spec_=0, unserved=False):
        return dict(estimate=est, lo=lo, hi=hi, epsilon=eps, spec=spec_,
                    unserved=unserved)
    limits = {"unanswered": 0, "over_eps": 0, "off_4hw_pct": 10.0}
    ok = check.judge([a(100.0, 99.0, 101.0)] * 10, [100.5], 0, limits)
    assert ok["correct"] and ok["numbers"]["off_4hw_pct"]["value"] == 0
    far = check.judge([a(100.0, 99.0, 101.0)] * 9
                      + [a(110.0, 109.0, 111.0)], [100.0], 0, limits)
    assert far["numbers"]["off_4hw_pct"]["value"] == pytest.approx(10.0)
    assert far["correct"]
    # the width is worked out from lo and hi, not taken from the program
    over = check.judge([a(100.0, 97.4, 102.6)], [100.0], 0, limits)
    assert over["numbers"]["over_eps"]["value"] == 1 and not over["correct"]
    # at epsilon exactly, with lo and hi rounded to float32, it holds
    f32 = [float(np.float32(x)) for x in (100.3, 100.3 - 2.5075,
                                           100.3 + 2.5075)]
    edge = check.judge([a(*f32)], [100.3], 0, limits)
    assert edge["numbers"]["over_eps"]["value"] == 0, edge
    lost = check.judge([a(float("nan"), 0, 1)], [1.0], 2, limits)
    assert lost["numbers"]["unanswered"]["value"] == 3
    assert not lost["correct"]
    assert not check.judge([], [], 0, limits)["correct"]
