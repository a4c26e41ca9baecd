"""Port parity: the batched serving engine (``repro_torch.serve.engine``)
against the JAX package's, on the CPU.

* With the reference engine's weights carried across
  (``load_reference_params``) at float32 compute, ``ServeEngine`` emits the
  reference's tokens, request for request, for the four dense archs at
  ``reduced=True`` and smollm-135m at ``tp=4`` (serve_batched.py's shape:
  6 requests of 8-token prompts, 3 slots, 12 new tokens; and a
  ``max_len`` that cuts requests short), with the same decode-step count.
  Greedy argmax over the reference's logits and the port's could differ
  only on a near tie; none occurs on these inputs.
* The padded vocabulary: the reference's argmax runs over all of
  ``pad_to(vocab, 256)`` logits, so a padding row can win.  With every
  real unembedding row zeroed and the first two padding rows set to ±u
  (qwen2.5-14b reduced, untied, its vocabulary cut to 500 so that 12
  padding rows exist), both engines emit ids ≥ ``vocab_size`` and the
  same ones.
* A second port engine from the same seed gives the same tokens; the
  default device is CUDA (raises without a card).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import get_config as t_config
from repro_torch.models.convert import load_reference_params
from repro_torch.serve.engine import Request as TRequest
from repro_torch.serve.engine import ServeEngine as TEngine

CASES = [("smollm-135m", 1), ("qwen3-0.6b", 1), ("qwen2.5-14b", 1),
         ("granite-34b", 1), ("smollm-135m", 4)]


def _engines(arch, tp, max_len=64, edit=None, **overrides):
    jc = dataclasses.replace(j_config(arch, tp=tp, reduced=True),
                             compute_dtype="float32", **overrides)
    tc = dataclasses.replace(t_config(arch, tp=tp, reduced=True),
                             compute_dtype="float32", **overrides)
    je = JEngine(jc, batch_slots=3, max_len=max_len, seed=0)
    if edit is not None:
        je.params = edit(je.params, jc)
    te = TEngine(tc, batch_slots=3, max_len=max_len, seed=0, device="cpu")
    load_reference_params(te.model, jax.tree.map(np.asarray, je.params))
    return je, te


def _serve(engine, request_cls, vocab, n=6, max_new=12, seed=0):
    rng = np.random.default_rng(seed)
    reqs = [request_cls(rid=i, prompt=rng.integers(0, vocab, 8)
                        .astype(np.int32), max_new=max_new)
            for i in range(n)]
    for r in reqs:
        engine.submit(r)
    steps = engine.run()
    return steps, reqs


@pytest.mark.parametrize("max_len", [64, 14])
@pytest.mark.parametrize("arch,tp", CASES)
def test_tokens_equal_reference(arch, tp, max_len):
    je, te = _engines(arch, tp, max_len)
    vocab = je.cfg.vocab_size
    js, jr = _serve(je, JRequest, vocab)
    ts, tr = _serve(te, TRequest, vocab)
    assert ts == js
    for a, b in zip(jr, tr):
        assert b.done == a.done and b.out_tokens == a.out_tokens, a.rid
    assert all(r.done for r in tr)
    if max_len == 64:
        assert all(len(r.out_tokens) == 12 for r in tr)
    else:       # slot_pos reaches max_len - 1 after 5 new tokens
        assert all(len(r.out_tokens) == max_len - 1 - 8 for r in tr)


def test_padded_vocabulary_rows_can_win():
    def edit(params, cfg):
        emb = np.array(params["unembed"])
        u = np.random.default_rng(3).normal(size=emb.shape[1])
        emb[: cfg.vocab_size] = 0.0
        emb[cfg.vocab_size] = u
        emb[cfg.vocab_size + 1] = -u
        return dict(params, unembed=jax.numpy.asarray(emb))

    # untied embeddings; 500 real rows padded to 512
    je, te = _engines("qwen2.5-14b", 1, edit=edit, vocab_size=500)
    vocab = je.cfg.vocab_size
    assert te.model.unembed.shape[0] > vocab + 1
    _, jr = _serve(je, JRequest, vocab, n=4, max_new=6)
    _, tr = _serve(te, TRequest, vocab, n=4, max_new=6)
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens
        assert set(b.out_tokens) <= {vocab, vocab + 1}


def test_same_seed_same_tokens_and_default_device():
    cfg = t_config("qwen3-0.6b", reduced=True)       # bf16 compute
    runs = []
    for _ in range(2):
        eng = TEngine(cfg, batch_slots=3, max_len=64, seed=4, device="cpu")
        runs.append([r.out_tokens for r in
                     _serve(eng, TRequest, cfg.vocab_size, n=4, max_new=5)[1]])
    assert runs[0] == runs[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TEngine(cfg, batch_slots=3, max_len=64)
