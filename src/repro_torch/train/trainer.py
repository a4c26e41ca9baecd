"""Trainer: segment-gated training loop with checkpoint/restart and failure
injection (counterpart of ``repro.train.trainer``).

Flow per segment (the production ingest pattern):

    1. OLA ingest gate verifies the segment's raw metadata table (PTF-style
       HAVING sequence, ε-accurate, early-terminated) on the device: on a
       CUDA device each round runs the fused extraction kernel.  Rejected
       segments are skipped *before* any batch is made or trained on.
    2. Admitted segments stream batches through the train step.
    3. Atomic checkpoints every ``ckpt_every`` steps; the failure injector
       can kill "devices" at a step boundary, triggering the recovery path
       (recompute the mesh shape via best_mesh_shape → restore → continue).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.corpus import SyntheticCorpus, standard_ingest_queries
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FailureInjector, best_mesh_shape
from repro_torch.models import build_model
from repro_torch.models.convert import tree_from_module
from repro_torch.ola_ml.verify import IngestGate
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps_per_segment: int = 20
    batch: int = 8
    seq_len: int = 128
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    max_steps: int = 10_000
    seed: int = 0
    gate_epsilon: float = 0.05


class Trainer:
    """Trains on the CUDA device unless ``device`` says otherwise."""

    def __init__(self, model_cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 injector: Optional[FailureInjector] = None, device=None):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg
        self.injector = injector
        self.device = resolve_device(device)
        self.model = build_model(model_cfg, device=self.device,
                                 seed=tcfg.seed)
        self.gate = IngestGate(standard_ingest_queries(tcfg.gate_epsilon),
                               device=self.device)
        self.step_fn = make_train_step(self.model.loss_fn, opt_cfg)
        self.restarts = 0
        self.log: list[dict] = []

    def init_state(self):
        """The module's random weights (``tcfg.seed``) as the first state.
        Training reads only the state's tree (the module lends
        ``loss_fn``), so once the tree is taken the module's own parameters
        move to the meta device: one copy of the weights on the device, not
        two.  A later call re-draws them from the seed."""
        if self.model.embedding.is_meta:
            self.model.to_empty(device=self.device)
            self.model.reset_parameters(self.tcfg.seed)
        state = init_train_state(tree_from_module(self.model))
        self.model.to("meta")
        return state

    def run(self, corpus: SyntheticCorpus, state=None) -> dict:
        tcfg = self.tcfg
        state = state or self.init_state()
        step = int(state.step)
        admitted = rejected = 0
        t0 = time.perf_counter()

        for seg in corpus.segments:
            if step >= tcfg.max_steps:
                break
            decision = self.gate.check(seg.meta_store)
            self.log.append({"event": "gate", "segment": seg.index,
                             "admitted": decision.admitted,
                             "tuples_ratio": decision.tuples_ratio,
                             "failed": decision.failed_query})
            if not decision.admitted:
                rejected += 1
                continue
            admitted += 1
            for batch in corpus.batches(seg, tcfg.batch, tcfg.seq_len,
                                        tcfg.steps_per_segment,
                                        seed=tcfg.seed):
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch.items()}
                state, metrics = self.step_fn(state, batch)
                step += 1
                self.log.append({"event": "step", "step": step,
                                 "loss": float(metrics["loss"]),
                                 "grad_norm": float(metrics["grad_norm"])})
                if tcfg.ckpt_dir and step % tcfg.ckpt_every == 0:
                    ckpt.save(tcfg.ckpt_dir, step, state,
                              extra={"segment": seg.index})
                if self.injector is not None:
                    delta = self.injector.check(step)
                    if delta is not None:
                        state = self._recover(state, delta)
                        self.restarts += 1
                if step >= tcfg.max_steps:
                    break

        losses = [e["loss"] for e in self.log if e["event"] == "step"]
        return {
            "steps": step,
            "admitted": admitted,
            "rejected": rejected,
            "restarts": self.restarts,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "wall_s": time.perf_counter() - t0,
            "state": state,
        }

    # ---------------------------------------------------------- recovery --
    def _recover(self, state, killed_devices: int):
        """Simulated failure: recompute the would-be mesh shape for the
        surviving device count (this process's CUDA devices, or 1 on the
        CPU), restore the last committed checkpoint onto the device — or
        reuse live state when no ckpt_dir is set.  As in the reference, the
        restored ``state.step`` is the checkpoint's while the loop's step
        count goes on."""
        total = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        n_dev = max(total - killed_devices, 1)
        shape = best_mesh_shape(n_dev, model_axis=1)
        self.log.append({"event": "failure", "survivors": n_dev,
                         "new_mesh": shape})
        if self.tcfg.ckpt_dir:
            last = ckpt.latest_step(self.tcfg.ckpt_dir)
            if last is not None:
                return ckpt.restore(self.tcfg.ckpt_dir, last, state,
                                    device=self.device)
        return state
