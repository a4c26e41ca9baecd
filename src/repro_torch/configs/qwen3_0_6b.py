"""qwen3-0.6b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family; hf].

28L, d_model 1024, 16 Q / 8 KV heads with head_dim 128 (qwen3 decouples
head_dim from d_model), SwiGLU d_ff 3072, vocab 151936, qk-norm, tied.
long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)
