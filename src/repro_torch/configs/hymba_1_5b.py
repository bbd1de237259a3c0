"""hymba-1.5b — hybrid: parallel attention + Mamba heads per block
[arXiv:2411.13676].

32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504, ssm_state=16.  Sliding
window (1024) in all but the first/middle/last layers (global), per the
paper.  Block output = ½(attn(u) + ssd(u)).  vocab=32001.

Eviction applies to the attention-head KV (partial applicability: the SSM
state is constant-size, DESIGN.md §5).
"""

from repro_torch.common.config import (AttentionConfig, LookaheadConfig,
                                       ModelConfig, SSMConfig)

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    attn=AttentionConfig(num_heads=25, num_kv_heads=5, head_dim=64,
                         sliding_window=1024, global_layers=(0, 15, 31)),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk_size=128),
    hybrid=True,
    source="arXiv:2411.13676 (Hymba)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke", arch_type="hybrid", num_layers=2, d_model=128,
        d_ff=256, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32,
                             sliding_window=16, global_layers=(0,)),
        ssm=SSMConfig(d_state=8, expand=2, head_dim=32, chunk_size=32),
        hybrid=True,
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
    )
