"""The port's trainer (``repro_torch.train.trainer``) against the JAX
package's, on the CPU.

* The reference's fault scenario (``tests/test_trainer_fault.py``: 4
  segments, ``poison_every=2``, a failure at step 6, ``ckpt_every=4``) in
  both packages from the same carried weights at float32 compute: the
  ``gate`` and ``failure`` log events equal field for field, and so do
  ``steps``, ``admitted``, ``rejected`` and ``restarts``; each step's loss
  within a relative 1e-3 (the reference's jitted step rounds its schedule
  and sums in other orders, and a restore replays two steps).
* After the restore, ``state.step`` is the checkpoint's while the loop's
  step count goes on, in both packages.
* A port-only overfit run lowers the loss; ``init_state`` leaves the
  module's weights to the state alone and re-draws them from the seed;
  ``Trainer()`` without a device raises when there is no card.
* On the card (marked ``cuda``): four steps of the reduced model at
  float32 compute (TF32 off) give the CPU's losses and first ``grad_norm``
  within a relative 1e-4 (the embedding's backward adds with atomics on
  the card); a checkpoint saved from the card restores onto it bit for
  bit.

The JAX package is imported inside the reference fixture only, so the card
tests run without it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as t_config
from repro_torch.data.corpus import SyntheticCorpus as TCorpus
from repro_torch.distributed import FailureInjector
from repro_torch.models import build_model as t_build
from repro_torch.models.convert import tree_from_module, tree_from_reference
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaves_with_paths, tree_map

SCENARIO = dict(steps_per_segment=4, batch=2, seq_len=64, max_steps=20,
                ckpt_every=4)
CORPUS = dict(num_segments=4, docs_per_segment=64, doc_len=64,
              poison_every=2, seed=0)
FAIL_AT = 6


def _events(log, kind):
    return [e for e in log if e["event"] == kind]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    from repro.configs import get_config as j_config
    from repro.data.corpus import SyntheticCorpus as JCorpus
    from repro.distributed.fault import FailureInjector as JInjector
    from repro.train.trainer import Trainer as JTrainer
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    import jax

    jc = dataclasses.replace(j_config("smollm-135m", reduced=True),
                             compute_dtype="float32")
    tc = dataclasses.replace(t_config("smollm-135m", reduced=True),
                             compute_dtype="float32")
    jt = JTrainer(jc, JTrainerConfig(
        **SCENARIO, ckpt_dir=str(tmp_path_factory.mktemp("jax_ckpt"))),
        injector=JInjector(fail_at_steps=(FAIL_AT,), kill_devices=0))
    jstate = jt.init_state()
    tstate = init_train_state(tree_from_reference(
        jax.tree.map(np.asarray, jstate.params), "cpu"))
    jres = jt.run(JCorpus(vocab=jc.vocab_size, **CORPUS), state=jstate)

    tt = Trainer(tc, TrainerConfig(
        **SCENARIO, ckpt_dir=str(tmp_path_factory.mktemp("torch_ckpt"))),
        injector=FailureInjector(fail_at_steps=(FAIL_AT,), kill_devices=0),
        device="cpu")
    tres = tt.run(TCorpus(vocab=tc.vocab_size, **CORPUS), state=tstate)
    return jt, jres, tt, tres


def test_scenario_matches_reference(both_runs):
    jt, jres, tt, tres = both_runs
    for kind in ("gate", "failure"):
        assert _events(tt.log, kind) == _events(jt.log, kind)
    for k in ("steps", "admitted", "rejected", "restarts"):
        assert tres[k] == jres[k], k
    assert (tres["steps"], tres["admitted"], tres["rejected"],
            tres["restarts"]) == (8, 2, 2, 1)
    jsteps, tsteps = _events(jt.log, "step"), _events(tt.log, "step")
    assert [e["step"] for e in tsteps] == [e["step"] for e in jsteps]
    for a, b in zip(tsteps, jsteps):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-3), a["step"]
        assert np.isfinite(a["grad_norm"])
    gates = {e["segment"]: e for e in _events(tt.log, "gate")}
    assert [gates[s]["admitted"] for s in range(4)] == [True, False, True,
                                                        False]
    assert all(g["tuples_ratio"] <= 1.0 for g in gates.values())
    assert any(g["tuples_ratio"] < 1.0 for g in gates.values())


def test_step_counter_goes_on_after_restore(both_runs):
    """The restore sets ``state.step`` back to the checkpoint (step 4)
    while the loop's count goes on: two steps are replayed, as in the
    reference."""
    jt, jres, tt, tres = both_runs
    replayed = FAIL_AT - SCENARIO["ckpt_every"]
    for res in (jres, tres):
        assert int(res["state"].step) == res["steps"] - replayed
        assert int(res["state"].opt.step) == res["steps"] - replayed
    assert tckpt.latest_step(tt.tcfg.ckpt_dir) == 8
    saved = tckpt.restore(tt.tcfg.ckpt_dir, 8,
                          tree_map(torch.zeros_like, tres["state"]))
    assert int(saved.step) == tres["steps"] - replayed
    assert tckpt.restore_extra(tt.tcfg.ckpt_dir, 8) == {"segment": 2}


def test_loss_improves_when_overfitting():
    cfg = t_config("smollm-135m", reduced=True)
    tcfg = TrainerConfig(steps_per_segment=30, batch=2, seq_len=64,
                         max_steps=30)
    corpus = TCorpus(vocab=cfg.vocab_size, num_segments=1,
                     docs_per_segment=128, doc_len=64, poison_every=0,
                     seed=1)
    result = Trainer(cfg, tcfg, device="cpu").run(corpus)
    assert result["steps"] == 30 and result["admitted"] == 1
    assert result["last_loss"] < result["first_loss"]


def test_init_state_keeps_one_copy_of_the_weights():
    """``init_state`` hands the module's weights to the state and leaves
    the module on the meta device; a second call re-draws the same tree,
    the tree ``tree_from_module`` takes of a module of the same seed."""
    cfg = t_config("smollm-135m", reduced=True)
    trainer = Trainer(cfg, TrainerConfig(seed=5), device="cpu")
    first = trainer.init_state()
    assert all(p.is_meta for p in trainer.model.parameters())
    second = trainer.init_state()
    assert all(p.is_meta for p in trainer.model.parameters())
    fresh = tree_from_module(t_build(cfg, device="cpu", seed=5))
    want = list(leaves_with_paths(fresh))
    for state in (first, second):
        got = list(leaves_with_paths(state.params))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert torch.equal(a, b), path


def test_trainer_default_device_is_cuda():
    cfg = t_config("smollm-135m", reduced=True)
    if torch.cuda.is_available():
        assert Trainer(cfg, TrainerConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(cfg, TrainerConfig())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    # decided here, per test, never at import
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _fixed_batches(cfg, n=4, shape=(2, 64), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (shape[0], shape[1] + 1))
        out.append({"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
                    "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)})
    return out


@pytest.mark.cuda
def test_card_steps_match_cpu(cuda_device):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(t_config("smollm-135m", reduced=True),
                                  compute_dtype="float32")
        model = t_build(cfg, device="cpu", seed=3)
        tree = tree_from_module(model)
        step = make_train_step(model.loss_fn, AdamWConfig(warmup_steps=2))
        states = {"cpu": init_train_state(tree),
                  "cuda": init_train_state(tree_map(
                      lambda t: t.to(cuda_device), tree))}
        for i, b in enumerate(_fixed_batches(cfg)):
            m = {}
            for dev in states:
                states[dev], m[dev] = step(
                    states[dev], {k: v.to(dev) for k, v in b.items()})
            assert float(m["cuda"]["loss"]) == pytest.approx(
                float(m["cpu"]["loss"]), rel=1e-4)
            if i == 0:
                assert float(m["cuda"]["grad_norm"]) == pytest.approx(
                    float(m["cpu"]["grad_norm"]), rel=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
def test_card_checkpoint_roundtrip(cuda_device, tmp_path):
    cfg = t_config("smollm-135m", reduced=True)
    model = t_build(cfg, device=cuda_device, seed=4)
    step = make_train_step(model.loss_fn, AdamWConfig(warmup_steps=0))
    state, _ = step(init_train_state(tree_from_module(model)),
                    {k: v.to(cuda_device)
                     for k, v in _fixed_batches(cfg, 1)[0].items()})
    tckpt.save(str(tmp_path), 1, state)
    back = tckpt.restore(str(tmp_path), 1, state, device=cuda_device)
    for (pa, a), (pb, b) in zip(leaves_with_paths(back),
                                leaves_with_paths(state)):
        assert pa == pb and a.device.type == "cuda" and torch.equal(a, b)
