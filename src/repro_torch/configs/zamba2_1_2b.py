"""zamba2-1.2b — hybrid Mamba2 + shared attention [arXiv:2411.15242; hf].

38 Mamba2 layers (d_state 64, headdim 64, expand 2), one weight-shared
attention+MLP block applied every 6 layers (32 heads, d_ff 8192),
d_model 2048, vocab 32000.  long_500k: RUNS — SSD is O(S); the shared
attention uses a 4096 sliding window in long-context serve (long_window).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    ssm_state=64, ssm_headdim=64, shared_attn_every=6,
    long_window=4096, tie_embeddings=True,
)
