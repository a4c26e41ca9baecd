"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf].

32L, d_model 4096, 32 Q / 8 KV heads (head_dim 128), 8 experts top-2 with
d_ff 14336, vocab 32000, SWA window 4096.  8 experts don't divide the 16-way
model axis -> experts stay TP-sharded on d_ff (DESIGN.md §7).
long_500k: RUNS — SWA is sub-quadratic and the decode cache is the window.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    num_experts=8, top_k=2, window=4096, rope_theta=1e6,
)
