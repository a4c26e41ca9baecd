"""Unified architecture config consumed by the model zoo (counterpart of
``repro.configs.base``; the same fields, defaults and counts).

One :class:`ModelConfig` describes any of the 10 assigned architectures; the
``family`` field selects the assembly
(``repro_torch.models.model_zoo.build_model``).  ``tp`` is the mesh
model-axis size the head padding is computed against (16 for the
production mesh; smoke tests use 1).

``remat`` recomputes each block in the backward pass of the model's
functional training path (``DecoderLM.apply``), as the reference's
``jax.checkpoint``.  ``scan_unroll`` is kept so that ``dataclasses.asdict``
equals the reference's; it steers the reference's ``lax.scan`` over layers
and has no effect in the port (its layers run in eager order).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | encdec | vlm | hybrid | xlstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # None -> d_model // num_heads
    # ---- attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding-window attention (mixtral)
    norm: str = "rms"                # rms | ln
    mlp: str = "swiglu"              # swiglu | gelu
    tie_embeddings: bool = False
    use_rope: bool = True
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl
    # ---- MoE
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    # ---- SSM / hybrid
    ssm_state: int = 64
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    shared_attn_every: int = 6       # zamba2: shared block cadence
    # ---- xLSTM
    slstm_at: Tuple[int, ...] = ()
    # ---- distribution / numerics
    tp: int = 1                      # model-axis size padding target
    remat: bool = True               # recompute blocks in the backward pass
    compute_dtype: str = "bfloat16"
    # the reference's lax.scan unroll for layer stacks (no effect in the port)
    scan_unroll: object = 1
    # ---- serving
    long_window: Optional[int] = None  # SWA override for long-context serve
    # ---- bookkeeping
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def with_tp(self, tp: int) -> "ModelConfig":
        return dataclasses.replace(self, tp=tp)

    def reduced(self) -> "ModelConfig":
        """Smoke-test configuration of the same family (CPU-sized)."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=max(self.num_heads // 4, 2) if self.num_heads >= 8 else self.num_heads,
            num_kv_heads=min(self.num_kv_heads, max(self.num_heads // 8, 1)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            shared_attn_every=2,
            slstm_at=(1,) if self.slstm_at else (),
            mrope_sections=(4, 6, 6) if self.mrope_sections else None,
            ssm_headdim=32,
            ssm_chunk=32,
            tp=1,
            remat=False,
        )


def param_count(cfg: ModelConfig) -> int:
    """Approximate *real* (unpadded) parameter count — the N of 6·N·D."""
    d, f, l, v = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
    hd = cfg.head_dim_
    attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    if cfg.family == "xlstm":
        per = 0
        for i in range(l):
            if i in cfg.slstm_at:
                dh = d
                per += 4 * (d * dh + (dh // cfg.num_heads) * dh) \
                    + dh * int(8.0 / 3.0 * d) + int(4.0 / 3.0 * d) * d
            else:
                din = 2 * d
                per += 2 * d * din + 3 * din * (din // cfg.num_heads) * cfg.num_heads // cfg.num_heads \
                    + din * d
        return per + 2 * v * d if not cfg.tie_embeddings else per + v * d
    if cfg.family == "hybrid":
        din = 2 * d
        n = cfg.ssm_state
        mamba = (2 * d * din + 2 * d * n + d * (din // cfg.ssm_headdim)
                 + din * d)
        shared = attn + 3 * d * f
        sites = l // cfg.shared_attn_every
        return l * mamba + shared + 2 * d * d * sites + v * d
    if cfg.num_experts:
        mlp = 3 * d * f * cfg.num_experts + d * cfg.num_experts
    elif cfg.mlp == "swiglu":
        mlp = 3 * d * f
    else:
        mlp = 2 * d * f
    per_layer = attn + mlp
    layers = l * (2 if cfg.family == "encdec" else 1)
    if cfg.family == "encdec":
        per_layer_dec = attn * 2 + mlp  # self + cross attention
        total = l * (attn + mlp) + l * per_layer_dec
    else:
        total = layers * per_layer
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return total + emb


def active_param_count(cfg: ModelConfig) -> int:
    """N_active for MoE rooflines (6·N_active·D)."""
    if not cfg.num_experts:
        return param_count(cfg)
    d, f, l = cfg.d_model, cfg.d_ff, cfg.num_layers
    hd = cfg.head_dim_
    attn = d * hd * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    mlp_active = 3 * d * f * cfg.top_k
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return l * (attn + mlp_active) + emb
