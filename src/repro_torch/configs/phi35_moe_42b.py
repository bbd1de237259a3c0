"""phi3.5-moe-42b-a6.6b — 16 experts, top-2 routing
[hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=6400, vocab=32064.
"""

from repro_torch.common.config import (AttentionConfig, LookaheadConfig,
                                       ModelConfig, MoEConfig)

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    d_ff=6400,
    vocab_size=32064,
    attn=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=6400),
    lookahead=LookaheadConfig(lora_targets=("wq", "wk", "wv", "wo")),
    tie_embeddings=False,
    fsdp=True,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi35-moe-smoke", arch_type="moe", num_layers=2, d_model=128,
        d_ff=128, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3,
                                  lora_targets=("wq", "wk", "wv", "wo")),
        tie_embeddings=False,
    )
