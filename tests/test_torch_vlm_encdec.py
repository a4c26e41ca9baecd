"""Port parity: the VLM (qwen2-vl-2b, M-RoPE) and encoder-decoder
(whisper-large-v3) families against the JAX package, on the CPU, at
``reduced=True``.

* Layers: ``apply_mrope`` (sections (16, 24, 24) at D = 128 and (4, 6, 6)
  at D = 32) within 4e-6 of max |ref| at float32 and one bf16 ulp at
  bf16; ``sinusoidal_positions`` and ``build_positions3`` equal bit for
  bit.
* VLM with carried weights: ``forward`` logits and aux, ``loss`` (text
  positions only), four text-phase decode steps (all three position
  streams at ``pos``) and their KV caches; float32 within 1e-5 of max
  |ref|, bf16 within 2 bf16 ulps, losses a relative 1e-5 / 1e-2.
* Encoder-decoder with carried weights: ``encode``, ``precompute_cross``
  (stacked (L, B, T, H, D) K and V), ``decode_full``, ``loss``, four decode
  steps over the cross K/V and the self-attention caches, at the same
  tolerances; the reference's Whisper decode-consistency oracle on the
  port (float32, rtol = atol = 2e-3).
* ``loss_fn`` gradients of both families equal ``jax.grad`` of the
  reference's loss (every leaf within 1e-4 of its max |grad|, none zero).
* Init: ``dec_pos`` at scale 0.01, LayerNorm weights one and biases zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import family_parity as fp
from repro.models import layers as jL
from repro.models import vlm as jvlm
from repro_torch.models import layers as tL
from repro_torch.models import vlm as tvlm

BF16_TOL = 2 * fp.BF16_ULP


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(16, 24, 24), (4, 6, 6)])
def test_mrope_matches_reference(sections, dtype):
    rng = np.random.default_rng(1)
    d = 2 * sum(sections)
    x = (rng.normal(size=(2, 7, 3, d)) * 3).astype(np.float32)
    pos3 = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = jL.apply_mrope(jnp.asarray(x).astype(dtype), jnp.asarray(pos3),
                              sections, theta)
        got = tL.apply_mrope(torch.as_tensor(x).to(getattr(torch, dtype)),
                             torch.as_tensor(pos3), sections, theta)
        assert got.dtype == getattr(torch, dtype)
        fp.close(got, want, 4e-6 if dtype == "float32" else fp.BF16_ULP)


def test_positions_equal_reference():
    for length, dim in ((1500, 1280), (10, 128), (7, 6)):
        assert np.array_equal(tL.sinusoidal_positions(length, dim).numpy(),
                              np.asarray(jL.sinusoidal_positions(length, dim)))
    for args in ((2, 256, 256), (3, 4, 12), (1, 7, 5), (2, 12, 3, (3, 4))):
        assert np.array_equal(tvlm.build_positions3(*args),
                              jvlm.build_positions3(*args))


def _decode_and_caches(jm, params, tm, jb, dtype, tol):
    steps, jc, tc = fp.decode_steps(jm, params, tm, np.asarray(jb["tokens"]),
                                    dtype)
    for jd, td in steps:
        fp.close(td, jd, tol, "decode logits")
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_carried_weights_give_reference_outputs(dtype):
    jm, params, tm = fp.pair("qwen2-vl-2b", dtype)
    f32 = dtype == "float32"
    tol = fp.F32 if f32 else BF16_TOL
    jb, tb = fp.batch(tm.cfg)
    jl, jaux = fp.j_forward(jm, params, jb)
    tl, taux = fp.t_forward(tm, tb)
    assert tl.shape[1] == fp.S and tl.dtype == getattr(torch, dtype)
    fp.close(tl, jl, tol, "logits")
    assert float(taux) == float(jaux) == 0.0
    assert float(tm.loss(tb)) == pytest.approx(float(jm.loss(params, jb)),
                                               rel=1e-5 if f32 else 1e-2)
    assert torch.equal(tm.prefill(tb), tl[:, -1:])
    jc, tc = _decode_and_caches(jm, params, tm, jb, dtype, tol)
    fp.same_caches(jc, tc, tol)


def _cross(jm, params, tm, jb, tb):
    jenc = jm.encode(params, jb["enc_embeds"])
    tenc = tm.encode(tb["enc_embeds"])
    return jenc, tenc, jm.precompute_cross(params, jenc), \
        tm.precompute_cross(tenc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_carried_weights_give_reference_outputs(dtype):
    jm, params, tm = fp.pair("whisper-large-v3", dtype)
    f32 = dtype == "float32"
    tol = fp.F32 if f32 else BF16_TOL
    jb, tb = fp.batch(tm.cfg)
    jenc, tenc, jkv, tkv = _cross(jm, params, tm, jb, tb)
    assert tenc.dtype == getattr(torch, dtype)
    fp.close(tenc, jenc, tol, "encode")
    for got, want in zip(tkv, jkv):
        assert got.shape == (tm.cfg.num_layers, fp.B, 10,
                             tm.self_cfg.kv_heads_padded, tm.cfg.head_dim_)
        fp.close(got, want, tol, "cross K/V")
    fp.close(tm.decode_full(tb["tokens"], tenc),
             jm.decode_full(params, jb["tokens"], jenc), tol, "decode_full")
    fp.close(tm.forward(tb), jm.forward(params, jb), tol, "forward")
    assert float(tm.loss(tb)) == pytest.approx(float(jm.loss(params, jb)),
                                               rel=1e-5 if f32 else 1e-2)
    toks = np.array(jb["tokens"])
    kw = {"dtype": jnp.float32} if f32 else {}
    jcache = jm.init_cache(fp.B, 32, **kw)
    tcache = tm.init_cache(fp.B, 32, **({"dtype": torch.float32} if f32
                                        else {}))
    for t in range(4):
        pos = np.asarray([t, t + 3], np.int32)
        jd, jcache = jm.decode_step(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(pos), jkv)
        td, tcache = tm.decode_step(tcache, torch.as_tensor(toks[:, t:t + 1]),
                                    torch.as_tensor(pos), tkv)
        fp.close(td, jd, tol, "decode logits")
    assert tcache["cross_k"] is None and tcache["cross_v"] is None
    fp.same_caches(jcache["self"], tcache["self"], tol)


def test_whisper_decode_consistency():
    """The reference's oracle on the port: decode over the precomputed
    cross K/V == ``decode_full`` (float32)."""
    _, tc = fp.configs("whisper-large-v3")
    tm = fp.t_build(tc, device="cpu", seed=1)
    rng = np.random.default_rng(2)
    enc = tm.encode(torch.as_tensor(rng.normal(size=(1, 8, tc.d_model)),
                                    dtype=torch.float32))
    toks = torch.as_tensor(rng.integers(0, tc.vocab_size, (1, 6)))
    full = tm.decode_full(toks, enc)
    ckv = tm.precompute_cross(enc)
    cache = tm.init_cache(1, 32, dtype=torch.float32)
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = tm.decode_step(cache, toks[:, t:t + 1],
                                       torch.full((1,), t, dtype=torch.int32),
                                       ckv)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-large-v3"])
def test_gradients_match_reference(arch):
    fp.grads_match(arch)


def test_init_draws_the_reference_distribution():
    _, tc = fp.configs("whisper-large-v3")
    tm = fp.t_build(tc, device="cpu", seed=2)
    pos = tm.dec_pos.numpy()
    assert pos.shape == (32768, tc.d_model)
    assert np.abs(pos).max() <= 0.02 and 0.85 < pos.std() / 0.01 < 0.9
    blk = tm.dec_layers[1]
    assert (blk.ln_x_w.numpy() == 1).all() and not blk.ln_x_b.numpy().any()
    assert (tm.enc_final_w.numpy() == 1).all()
    assert not tm.enc_layers[0].mlp.b1.numpy().any()
    wq = blk.cross_attn.wq.numpy()
    s = np.sqrt(tc.d_model)
    assert np.abs(wq).max() <= 2 / s and 0.85 < wq.std() * s < 0.9


def test_engine_tokens_equal_reference():
    """The VLM decodes text through the engine (M-RoPE's text phase)."""
    fp.engine_tokens_match("qwen2-vl-2b")


def test_engine_refuses_the_encoder_decoder():
    _, tc = fp.configs("whisper-large-v3")
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(ValueError, match="cross K/V"):
        ServeEngine(tc, device="cpu")


def test_text_positions_are_the_references():
    """A property both packages share: ``build_positions3`` starts the
    text at max(grid) (16 after 256 patches on a 16 x 16 grid), while
    decode rotates all three streams by ``pos``: text decoded at
    ``pos = t`` equals the forward whose three streams all sit at t."""
    p3 = tvlm.build_positions3(1, 256, 4)
    assert p3[:, 0, 256:].tolist() == [[16, 17, 18, 19]] * 3
    assert np.array_equal(p3, jvlm.build_positions3(1, 256, 4))
    _, tc = fp.configs("qwen2-vl-2b")
    tm = fp.t_build(tc, device="cpu", seed=1)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tc.vocab_size, (1, 3)))
    want, _ = tm.forward({"vis_embeds": torch.zeros(1, 0, tc.d_model),
                          "tokens": toks,
                          "positions3": torch.arange(3).expand(3, 1, 3)})
    cache = tm.init_cache(1, 16, dtype=torch.float32)
    for t in range(3):
        got, cache = tm.decode_step(cache, toks[:, t:t + 1],
                                    torch.full((1,), t, dtype=torch.int32))
        fp.close(got[:, 0], want[:, t], fp.F32)
