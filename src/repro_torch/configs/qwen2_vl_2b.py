"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

28L, d_model 1536, 12 Q / 2 KV heads (head_dim 128), SwiGLU d_ff 8960,
vocab 151936, QKV bias, M-RoPE sections (16, 24, 24).  Vision frontend
stubbed: input_specs supplies patch embeddings + 3-stream position ids.
long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, mrope_sections=(16, 24, 24), tie_embeddings=True,
)
