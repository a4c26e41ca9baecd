"""granite-34b — llama-arch code model, MQA [arXiv:2405.04324; hf].

88L, d_model 6144, 48 Q heads / 1 KV head (MQA, head_dim 128), SwiGLU
d_ff 24576, vocab 49152.  The deepest assigned arch — the scan-over-layers
compile-time case.  long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
)
