"""Port parity: the dense model family (``repro_torch.configs``,
``repro_torch.models``) against the JAX package, on the CPU.

* ``ModelConfig``: every arch's config, full and reduced, equals the
  reference's field for field (``dataclasses.asdict``), with the same
  parameter counts; the registry's shapes and cells are the reference's.
* Weights carried across: the reference's ``init`` on a JAX key, loaded
  with ``load_reference_params``, for the four dense archs at
  ``reduced=True`` (smollm-135m, qwen3-0.6b with qk-norm, qwen2.5-14b with
  QKV bias and untied embeddings, granite-34b with MQA) and smollm-135m at
  ``tp=4`` (padded heads), plus the GELU MLP and a five-position sliding
  window (no dense config sets either; decode then runs a ring-buffer
  cache).  ``forward`` logits, ``loss``, and four cached decode steps'
  logits and KV caches agree:
  - float32 compute, float32 cache: logits and cached K/V within 1e-5 ·
    max|ref| (the two libraries' float32 matrix products sum in other
    orders), losses within a relative 1e-5;
  - bfloat16 compute, the default bfloat16 cache: logits and K/V within
    2^-7 · max|ref| (one bf16 ulp at the largest entry), losses within a
    relative 1e-2;
  - cached positions equal.
* Inside the port, cached decode equals the full-sequence forward
  (float32 compute and cache, 1e-5 · max|logit|), as the reference's own
  ``test_decode_matches_forward``.
* ``load_reference_params`` refuses a missing leaf, an extra leaf, a wrong
  shape and a wrong layer count; families not yet ported are refused by
  name; ``build_model`` without a device raises when there is no card.
* The layers (``rms_norm``, ``apply_rope``, ``cross_entropy_loss``,
  ``real_head_mask``) against the reference's, float32 within 1e-6
  relative; the port's initialiser draws a truncated normal at the
  reference's scales and zeroes the padded heads' ``wo`` rows.
* On the card (marked ``cuda``): the same weights give the CPU's float32
  logits and decode (TF32 off).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import base as jbase
from repro.configs import get_config as j_config
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import build_model as j_build
from repro.models import layers as jL
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as t_config
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as tL
from repro_torch.models.convert import load_reference_params
from repro_torch.models.transformer import DecoderLM

DENSE = ("smollm-135m", "qwen3-0.6b", "qwen2.5-14b", "granite-34b")
# (arch, tp, overrides): the dense archs at reduced size, smollm with
# padded heads, and the two options no dense config sets: the GELU MLP and
# a sliding window (a five-slot ring-buffer cache in decode)
CASES = ([(a, 1, {}) for a in DENSE] + [("smollm-135m", 4, {}),
         ("smollm-135m", 1, {"mlp": "gelu"}), ("qwen3-0.6b", 1, {"window": 5})])
B, S = 2, 16
BF16_ULP = 2.0 ** -7


def _configs(arch, tp, dtype, overrides=None):
    jc = dataclasses.replace(j_config(arch, tp=tp, reduced=True),
                             compute_dtype=dtype, **(overrides or {}))
    tc = dataclasses.replace(t_config(arch, tp=tp, reduced=True),
                             compute_dtype=dtype, **(overrides or {}))
    return jc, tc


def _pair(arch, tp, dtype, overrides):
    """The reference model with JAX-initialised weights and the port's
    model carrying the same weights."""
    jc, tc = _configs(arch, tp, dtype, overrides)
    jm = j_build(jc)
    params, _ = jm.init(jax.random.PRNGKey(1))
    tm = t_build(tc, device="cpu", seed=5)
    load_reference_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, tol_frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = tol_frac * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch, reduced):
    for tp in (1, 4, 16):
        jc = j_config(arch, tp=tp, reduced=reduced)
        tc = t_config(arch, tp=tp, reduced=reduced)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert jc.head_dim_ == tc.head_dim_
        assert jbase.param_count(jc) == tbase.param_count(tc)
        assert jbase.active_param_count(jc) == tbase.active_param_count(tc)


def test_registry_equals_reference():
    assert treg.ARCHS == jreg.ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in treg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jreg.SHAPES.items()})
    assert treg.LONG_OK == jreg.LONG_OK
    for skipped in (False, True):
        assert treg.cells(skipped) == jreg.cells(skipped)


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,tp,overrides", CASES)
def test_carried_weights_give_reference_outputs(arch, tp, overrides, dtype):
    jm, params, tm = _pair(arch, tp, dtype, overrides)
    cfg = tm.cfg
    toks = _tokens(cfg)
    labels = _tokens(cfg, seed=9)
    f32 = dtype == "float32"
    tol = 1e-5 if f32 else BF16_ULP

    jl, _ = jm.forward(params, jnp.asarray(toks))
    tl, aux = tm.forward(torch.as_tensor(toks))
    assert tl.dtype == getattr(torch, dtype) and float(aux) == 0.0
    assert tl.shape[-1] == tL.pad_to(cfg.vocab_size, 256)
    _close(_f32(tl), _f32(jl), tol)

    jloss = float(jm.loss(params, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)}))
    tloss = float(tm.loss({"tokens": torch.as_tensor(toks),
                           "labels": torch.as_tensor(labels)}))
    assert tloss == pytest.approx(jloss, rel=1e-5 if f32 else 1e-2)

    jcache = jm.init_cache(B, 32, **({"dtype": jnp.float32} if f32 else {}))
    tcache = tm.init_cache(B, 32, **({"dtype": torch.float32} if f32 else {}))
    for t in range(4):
        pos = np.full(B, t, np.int32)
        pos[1] = t + 3      # the slots sit at different positions
        jd, jcache = jm.decode_step(params, jcache,
                                    jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(pos))
        td, tcache = tm.decode_step(tcache, torch.as_tensor(toks[:, t:t + 1]),
                                    torch.as_tensor(pos))
        _close(_f32(td), _f32(jd), tol)
    for k in ("k", "v"):
        assert tcache[k].dtype == (torch.float32 if f32 else torch.bfloat16)
        _close(_f32(tcache[k]), _f32(jcache[k]), tol)
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    # prefill is forward's last position
    assert torch.equal(tm.prefill(torch.as_tensor(toks)), tl[:, -1:])


@pytest.mark.parametrize("arch,tp,overrides", CASES)
def test_decode_matches_forward(arch, tp, overrides):
    """Inside the port: cached decode (float32 cache) reproduces the
    full-sequence forward's logits."""
    _, tc = _configs(arch, tp, "float32", overrides)
    tm = t_build(tc, device="cpu", seed=3)
    toks = torch.as_tensor(_tokens(tc, seed=4, shape=(2, 12)))
    full, _ = tm.forward(toks)
    cache = tm.init_cache(2, 64, dtype=torch.float32)
    outs = []
    for t in range(toks.shape[1]):
        pos = torch.full((2,), t, dtype=torch.int32)
        logits, cache = tm.decode_step(cache, toks[:, t:t + 1], pos)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, 1).numpy(), full.numpy(), 1e-5)


def test_compute_copy_follows_parameter_changes():
    """At bf16 compute the module keeps one cast of its weights and
    re-makes it after a parameter changes."""
    _, tc = _configs("qwen3-0.6b", 1, "bfloat16")
    tm = t_build(tc, device="cpu", seed=1)
    w = tm.compute_params()
    assert w is tm.compute_params()
    assert w["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(w["embedding"], tm.embedding.to(torch.bfloat16))
    with torch.no_grad():
        tm.layers[1].mlp.up.mul_(2.0)
    w2 = tm.compute_params()
    assert w2 is not w
    assert torch.equal(w2["layers"][1]["mlp"]["up"],
                       tm.layers[1].mlp.up.to(torch.bfloat16))
    _, tc32 = _configs("qwen3-0.6b", 1, "float32")
    tm32 = t_build(tc32, device="cpu", seed=1)
    assert tm32.compute_params()["layers"][0]["ln1"].data_ptr() == \
        tm32.layers[0].ln1.data_ptr()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _ref_tree():
    jc, _ = _configs("qwen3-0.6b", 1, "float32")
    params, _ = j_build(jc).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "layers"])
def test_load_reference_params_refuses_mismatch(fault):
    _, tc = _configs("qwen3-0.6b", 1, "float32")
    tm = t_build(tc, device="cpu")
    tree = _ref_tree()
    if fault == "missing":
        del tree["layers"]["attn"]["k_norm"]
        match = "no reference leaf fills"
    elif fault == "extra":
        tree["layers"]["attn"]["bq"] = np.zeros(
            (tc.num_layers, tc.num_heads, tc.head_dim_), np.float32)
        match = "has no parameter"
    elif fault == "shape":
        tree["final_norm"] = np.ones(tc.d_model + 1, np.float32)
        match = "shape"
    else:
        tree["layers"]["ln1"] = tree["layers"]["ln1"][:1]
        match = "stacked layers"
    with pytest.raises(ValueError, match=match):
        load_reference_params(tm, tree)
    load_reference_params(tm, _ref_tree())      # the whole tree loads


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if j_config(a).family != "dense"])
def test_unported_families_are_refused(arch):
    cfg = t_config(arch, reduced=True)
    with pytest.raises(ValueError, match="not yet ported"):
        t_build(cfg, device="cpu")


def test_moe_layers_are_refused_in_a_dense_model():
    cfg = dataclasses.replace(t_config("smollm-135m", reduced=True),
                              num_experts=4)
    with pytest.raises(ValueError, match="models/moe.py"):
        DecoderLM(cfg, device="cpu")


def test_default_device_is_cuda():
    cfg = t_config("smollm-135m", reduced=True)
    if torch.cuda.is_available():
        assert t_build(cfg).embedding.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_build(cfg)


# ---------------------------------------------------------------------------
# layers and init
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32) * 3
    w = rng.normal(size=32).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    for dt in ("float32", "bfloat16"):
        jx = jnp.asarray(x).astype(dt)
        tx = torch.as_tensor(x).to(getattr(torch, dt))
        tol = 1e-6 if dt == "float32" else BF16_ULP
        _close(_f32(tL.rms_norm(tx, torch.as_tensor(w))),
               _f32(jL.rms_norm(jx, jnp.asarray(w))), tol)
        for theta in (1e4, 1e6):
            _close(_f32(tL.apply_rope(tx, torch.as_tensor(pos), theta)),
                   _f32(jL.apply_rope(jx, jnp.asarray(pos), theta)),
                   4e-6 if dt == "float32" else BF16_ULP)
    logits = rng.normal(size=(2, 7, 256)).astype(np.float32) * 4
    labels = rng.integers(0, 200, (2, 7)).astype(np.int32)
    labels[0, 2] = -100
    assert float(tL.cross_entropy_loss(
        torch.as_tensor(logits), torch.as_tensor(labels), 200)) == \
        pytest.approx(float(jL.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels), 200)), rel=1e-6)
    for heads, kv, tp in ((9, 3, 4), (9, 3, 16), (16, 8, 1), (48, 1, 16),
                          (40, 8, 16), (14, 2, 4)):
        assert tattn.padded_heads(heads, kv, tp) == \
            jattn.padded_heads(heads, kv, tp)
        hp, hk = tattn.padded_heads(heads, kv, tp)
        a = dict(d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=8,
                 heads_padded=hp, kv_heads_padded=hk)
        assert np.array_equal(
            tattn.real_head_mask(tattn.AttnConfig(**a)).numpy(),
            np.asarray(jattn.real_head_mask(jattn.AttnConfig(**a))))


def test_init_draws_the_reference_distribution():
    _, tc = _configs("smollm-135m", 4, "float32")
    tm = t_build(tc, device="cpu", seed=2)
    emb = tm.embedding.numpy()
    assert np.abs(emb).max() <= 2.0 and 0.8 < emb.std() < 0.9
    wq = tm.layers[0].attn.wq.numpy()
    s = np.sqrt(tc.d_model)
    assert np.abs(wq).max() <= 2.0 / s and 0.8 < wq.std() * s < 0.9
    assert (tm.layers[0].ln1.numpy() == 1.0).all()
    keep = tattn.real_head_mask(tm.acfg).numpy()
    assert keep.sum() == tc.num_heads < tm.acfg.heads_padded
    wo = tm.layers[0].attn.wo.numpy()
    assert not wo[keep == 0].any() and wo[keep == 1].all()
    again = t_build(tc, device="cpu", seed=2)
    assert torch.equal(again.layers[1].mlp.down, tm.layers[1].mlp.down)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    # decided here, per test, never at import
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,tp,overrides", CASES)
def test_card_matches_cpu(cuda_device, arch, tp, overrides):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, tc = _configs(arch, tp, "float32", overrides)
        card = t_build(tc, device=cuda_device, seed=3)
        cpu = t_build(tc, device="cpu", seed=0)
        cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        toks = torch.as_tensor(_tokens(tc))
        _close(card.forward(toks.to(cuda_device))[0].cpu().numpy(),
               cpu.forward(toks)[0].numpy(), 1e-5)
        # float32 caches: a bf16 cache may round a K or V entry that sits
        # near a rounding midpoint one way on each device
        cc = card.init_cache(B, 16, dtype=torch.float32)
        hc = cpu.init_cache(B, 16, dtype=torch.float32)
        for t in range(3):
            pos = torch.full((B,), t, dtype=torch.int32)
            a, cc = card.decode_step(cc, toks[:, t:t + 1].to(cuda_device),
                                     pos.to(cuda_device))
            b, hc = cpu.decode_step(hc, toks[:, t:t + 1], pos)
            _close(a.cpu().numpy(), b.numpy(), 1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
