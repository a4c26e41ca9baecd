"""qwen2.5-14b — dense GQA decoder [hf:Qwen/Qwen2.5-0.5B family; hf].

48L, d_model 5120, 40 Q heads / 8 KV heads (head_dim 128), SwiGLU d_ff 13824,
vocab 152064, QKV bias, rope theta 1e6.  TP16 pads Q heads 40->48.
long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
)
