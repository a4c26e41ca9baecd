"""smollm-135m — llama-arch small dense [hf:HuggingFaceTB/SmolLM-135M; hf].

30L, d_model 576, 9 Q / 3 KV heads (head_dim 64), SwiGLU d_ff 1536,
vocab 49152, tied embeddings.  TP16 pads heads 9->16 (KV 3->4).
This is the ~135M end-to-end training example arch.
long_500k: SKIPPED — full attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    d_ff=1536, vocab_size=49152, head_dim=64, tie_embeddings=True,
)
