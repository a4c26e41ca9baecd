"""whisper-large-v3 — enc-dec audio backbone [arXiv:2212.04356; unverified].

32 encoder + 32 decoder layers (whisper-large has both stacks; the
assignment's "32L"), d_model 1280, 20 MHA heads, GELU MLP d_ff 5120,
vocab 51866.  Conv frontend stubbed: input_specs supplies frame embeddings.
long_500k: SKIPPED — full (enc-dec) attention, no sub-quadratic path.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866, head_dim=64,
    norm="ln", mlp="gelu", use_rope=False, tie_embeddings=True,
    notes="audio; conv frontend stubbed (frame embeddings supplied)",
)
