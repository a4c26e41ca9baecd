"""Batched serving engine: prefill + decode with slot-based continuous
batching (counterpart of ``repro.serve.engine``).

Requests occupy batch *slots*; each decode step advances every slot by one
token.  Finished slots are refilled from the queue without draining the
batch.  Prefill is teacher-forced decode steps, one a prompt token, that
fill the slot's cache token by token (every slot takes part in each such
step, as in the reference).  Greedy decoding takes the argmax over the
padded vocabulary, as the reference's does, so a padding row's id (>=
``vocab_size``) can be emitted; the next tokens are read to the host once a
step.  The KV cache is written in place.  Runs on the CUDA device unless
``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, batch_slots: int = 4,
                 max_len: int = 512, seed: int = 0, greedy: bool = True,
                 device=None):
        self.cfg = cfg
        self.model = build_model(cfg, device=device, seed=seed)
        self.device = self.model.embedding.device
        self.slots = batch_slots
        self.max_len = max_len
        self.greedy = greedy        # as in the reference, decoding is argmax
        self.cache = self.model.init_cache(batch_slots, max_len)
        # slot state
        self.slot_req: list[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.slot_tok = np.zeros(batch_slots, np.int32)
        self.queue: list[Request] = []
        self.steps = 0

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """The slot state as a device tensor: on the card a pinned copy sent
        without waiting for the stream (the host may change ``a`` at
        once); the only host read a step is the next tokens."""
        t = torch.as_tensor(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _decode(self, toks: np.ndarray, posv: np.ndarray) -> torch.Tensor:
        logits, self.cache = self.model.decode_step(
            self.cache, self._upload(toks), self._upload(posv))
        return logits

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[s] = req
                # prefill via teacher-forced decode steps (cache fills token
                # by token; simple and family-uniform)
                for t, tok in enumerate(req.prompt):
                    self.slot_pos[s] = t
                    self.slot_tok[s] = tok
                    self._step_single_fill(s, t, tok)
                self.slot_pos[s] = len(req.prompt)

    def _step_single_fill(self, slot: int, pos: int, tok: int):
        toks = self.slot_tok[:, None].copy()
        toks[slot, 0] = int(tok)
        posv = self.slot_pos.copy()
        posv[slot] = int(pos)
        self._last_logits = self._decode(toks, posv)

    # -------------------------------------------------------------- decode --
    def step(self):
        """One batched decode step across all active slots."""
        self._admit()
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return False
        logits = self._decode(self.slot_tok[:, None], self.slot_pos)
        self.steps += 1
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            req.out_tokens.append(int(nxt[s]))
            self.slot_tok[s] = nxt[s]
            self.slot_pos[s] += 1
            if (len(req.out_tokens) >= req.max_new
                    or self.slot_pos[s] >= self.max_len - 1):
                req.done = True
                self.slot_req[s] = None
        return True

    def run(self, max_steps: int = 10_000, wall_timeout_s: float = 120.0):
        t0 = time.perf_counter()
        while self.queue or any(r is not None for r in self.slot_req):
            if not self.step():
                break
            if (self.steps >= max_steps
                    or time.perf_counter() - t0 > wall_timeout_s):
                break
        return self.steps
