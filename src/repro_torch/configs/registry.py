"""Registry of the 10 assigned architectures (+ shape sets); counterpart of
``repro.configs.registry``.

``--arch <id>`` everywhere resolves through :func:`get_config`.
Shapes follow the assignment:

    train_4k     seq 4096,   global_batch 256   (train_step)
    prefill_32k  seq 32768,  global_batch 32    (serve prefill)
    decode_32k   seq 32768,  global_batch 128   (serve decode: 1 new token,
                                                 KV/recurrent state of 32k)
    long_500k    seq 524288, global_batch 1     (long-context decode; only
                                                 sub-quadratic families)
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k runs only for sub-quadratic families (per-arch notes in configs/)
LONG_OK = {"zamba2-1.2b", "xlstm-125m", "mixtral-8x7b"}


def get_config(arch: str, tp: int = 1, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    cfg: ModelConfig = mod.CONFIG
    if reduced:
        cfg = cfg.reduced()
    return cfg.with_tp(tp)


def list_archs() -> tuple:
    return ARCHS


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; skipped long_500k cells flagged."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and arch not in LONG_OK
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name, skipped))
    return out
