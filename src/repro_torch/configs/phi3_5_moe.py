"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L, d_model 4096, 32 Q / 8 KV heads (head_dim 128), 16 experts top-2 with
d_ff 6400, vocab 32064.  16 experts / 16-way model axis = pure expert
parallelism (1 expert per shard).  SparseMixer router approximated by
normalized top-2 softmax (DESIGN.md).  long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064, head_dim=128,
    num_experts=16, top_k=2,
)
