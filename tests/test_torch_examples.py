"""The port's examples (``repro_torch.examples``) on the CPU.

* quickstart, serve_ola_workload, trace_workload and explore_ptf print the
  reports of their JAX counterparts in ``examples/`` line for line, at the
  same default sizes (the trace file's path aside); quickstart's and
  serve_ola_workload's answers are within 3·ε of their exact values.
* ola_eval_demo and serve_batched run at their defaults: the evaluation
  stops early within 3·ε of its exhaustive mean, every request is served
  with its tokens.  (Their random weights come from torch's generator, not
  JAX's, so their numbers are not the reference's; the model and engine
  parity tests hold those with the weights carried across.)
* train_with_verification at ``--steps 12``: its ingest gate lines and its
  ``steps``, ``admitted``, ``rejected`` and ``restarts`` equal the JAX
  example's; its losses (torch's random weights) are finite and fall.
* Without a card, every example called with its default device raises.
"""

import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAMES = ("quickstart", "serve_ola_workload", "trace_workload", "explore_ptf",
         "ola_eval_demo", "serve_batched", "train_with_verification")


def _port(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _reference(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ref_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within(estimate, exact, eps):
    return abs(estimate - exact) <= 3 * eps * abs(exact)


@pytest.mark.parametrize("name", ["quickstart", "serve_ola_workload",
                                  "trace_workload", "explore_ptf"])
def test_report_equals_reference(name, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)     # the reference's trace lands here
    _reference(name).main()
    want = capsys.readouterr().out
    args = ["--device", "cpu"]
    if name == "trace_workload":
        args += ["--out", str(tmp_path / "port_trace.json")]
    out = _port(name).main(args)
    got = capsys.readouterr().out
    if name == "trace_workload":
        want = want.replace("wrote ola_trace.json", "wrote PATH")
        got = got.replace(f"wrote {tmp_path / 'port_trace.json'}",
                          "wrote PATH")
        assert (tmp_path / "port_trace.json").exists()
    assert got == want
    if name == "quickstart":
        q = out["query"]
        assert _within(float(out["result"].final_estimate[0]), out["exact"],
                       q.epsilon)
    elif name == "serve_ola_workload":
        x = out["values"] @ np.asarray([1.0 / (k + 1) for k in range(8)])
        exact = {"sum-all": x.sum(), "sum-tight": x.sum(),
                 "avg-all": x.mean()}
        eps = {q.name: q.epsilon for q in out["queries"]}
        for r in out["results"]:
            if r.name in exact:
                assert _within(r.estimate, exact[r.name], eps[r.name]), r.name


def test_ola_eval_demo_runs(capsys):
    out = _port("ola_eval_demo").main(["--device", "cpu"])
    res = out["result"]
    assert res.examples_used < out["total"]
    assert _within(res.estimate, out["exhaustive"], 0.02)
    assert "examples used" in capsys.readouterr().out


def test_serve_batched_runs(capsys):
    out = _port("serve_batched").main(["--device", "cpu"])
    assert out["report"]["all_done"] and out["report"]["requests"] == 6
    assert all(len(r.out_tokens) == 12 for r in out["requests"])
    assert '"decode_steps"' in capsys.readouterr().out


def _train_report(text):
    """(the result JSON, the ingest gate lines) of a train report."""
    head, rest = text.split("\ningest gate log:\n", 1)
    gates = rest.split("\n\n", 1)[0].splitlines()
    return json.loads(head), gates


def test_train_with_verification_gates_like_reference(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_with_verification.py",
                                      "--steps", "12"])
    _reference("train_with_verification").main()
    want, want_gates = _train_report(capsys.readouterr().out)
    out = _port("train_with_verification").main(["--device", "cpu",
                                                 "--steps", "12"])
    got, got_gates = _train_report(capsys.readouterr().out)
    assert got_gates == want_gates and len(got_gates) == 8
    for k in ("steps", "admitted", "rejected", "restarts"):
        assert got[k] == want[k], k
    assert (got["steps"], got["admitted"], got["rejected"]) == (12, 6, 2)
    losses = [e["loss"] for e in out["log"] if e["event"] == "step"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    args = ["--out", str(tmp_path / "t.json")] if name == "trace_workload" \
        else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port(name).main(args)
