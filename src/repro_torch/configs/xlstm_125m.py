"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12 blocks, d_model 768, 4 heads, vocab 50304; sLSTM at positions (5, 11)
(~the paper's mLSTM:sLSTM ratio), no separate FFN (d_ff = 0; block-internal
projections).  Runs replicated-TP / batch-over-both-axes (DESIGN.md §6).
long_500k: RUNS — O(1) recurrent state.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, slstm_at=(5, 11), tie_embeddings=True,
    ssm_chunk=256,  # mLSTM chunkwise-parallel block length
)
