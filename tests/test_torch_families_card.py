"""The model families on the card against the CPU (marked ``cuda``; they
skip without a card).  No JAX here: the CPU port is the yardstick.

For each family at ``reduced=True`` and float32 compute (TF32 off), the
same weights on the card and the CPU (the card module's copied into a CPU
module built on the meta device): ``forward`` logits, three decode steps'
logits within 1e-5 of max |CPU|, one ``loss_fn`` gradient within 1e-4 of
each leaf's max |CPU grad| (the embedding's backward adds with atomics on
the card; a leaf of rounding noise below 1e-6 of the largest gradient
stays below it); the MoE dispatch's integer state equal on both devices.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.convert import tree_from_module
from repro_torch.models.vlm import build_positions3
from repro_torch.train.train_step import value_and_grad
from repro_torch.tree import leaves, tree_map

ARCHS = ("mixtral-8x7b", "qwen2-vl-2b", "whisper-large-v3", "zamba2-1.2b",
         "xlstm-125m")


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _batch(cfg, rng, b=2, s=16):
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s))),
           "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))}
    if cfg.family == "vlm":
        out["vis_embeds"] = torch.as_tensor(
            rng.normal(size=(b, 4, cfg.d_model)), dtype=torch.float32)
        out["positions3"] = torch.as_tensor(build_positions3(b, 4, s))
    if cfg.family == "encdec":
        out["enc_embeds"] = torch.as_tensor(
            rng.normal(size=(b, 10, cfg.d_model)), dtype=torch.float32)
    return out


def _logits(model, batch):
    fam = model.cfg.family
    out = model.forward(batch) if fam in ("vlm", "encdec") else \
        model.forward(batch["tokens"])
    return out[0] if isinstance(out, tuple) else out


def _close(a, b, tol):
    a, b = a.double().cpu(), b.double().cpu()
    assert float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_matches_cpu(cuda_device, arch):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="float32")
    card = build_model(cfg, device=cuda_device, seed=3)
    cpu = build_model(cfg, device="meta")
    cpu.to_empty(device="cpu")
    cpu.load_state_dict(card.state_dict())
    batch = _batch(cfg, np.random.default_rng(0))
    on_card = {k: v.to(cuda_device) for k, v in batch.items()}
    rec = {}
    real = moe_mod.moe_dispatch
    for dev, model, b in (("card", card, on_card), ("cpu", cpu, batch)):
        calls = rec[dev] = []

        def spy(probs, k, cap, calls=calls):
            out = real(probs, k, cap)
            calls.append([t.cpu() for t in out[1:]])
            return out

        moe_mod.moe_dispatch = spy
        try:
            rec[dev + "_logits"] = _logits(model, b)
        finally:
            moe_mod.moe_dispatch = real
    _close(rec["card_logits"], rec["cpu_logits"], 1e-5)
    assert len(rec["card"]) == len(rec["cpu"])
    for a, b in zip(rec["card"], rec["cpu"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    caches = [m.init_cache(2, 16, dtype=torch.float32) for m in (card, cpu)]
    kv = [None, None]
    if cfg.family == "encdec":
        kv = [card.precompute_cross(card.encode(on_card["enc_embeds"])),
              cpu.precompute_cross(cpu.encode(batch["enc_embeds"]))]
    for t in range(3):
        pos = torch.full((2,), t, dtype=torch.int32)
        out = []
        for m, c, x, dev in zip((card, cpu), caches, kv,
                                (cuda_device, torch.device("cpu"))):
            args = (c, batch["tokens"][:, t:t + 1].to(dev), pos.to(dev))
            out.append(m.decode_step(*args, *([x] if x is not None
                                              else []))[0])
        _close(out[0], out[1], 1e-5)

    tree = tree_from_module(cpu)
    _, g_cpu = value_and_grad(cpu.loss_fn, tree, batch)
    _, g_card = value_and_grad(card.loss_fn, tree_map(
        lambda t: t.to(cuda_device), tree), on_card)
    # a leaf below 1e-6 of the largest gradient is rounding noise around a
    # true zero (the input gate's bias): it stays below that floor
    floor = 1e-6 * max(float(b.abs().max()) for b in leaves(g_cpu))
    for a, b in zip(leaves(g_card), leaves(g_cpu)):
        a, scale = a.cpu(), float(b.abs().max())
        if scale <= floor:
            assert float(a.abs().max()) <= floor
        else:
            assert float((a - b).abs().max()) <= 1e-4 * scale
