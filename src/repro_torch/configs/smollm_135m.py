"""smollm-135m — llama-architecture small dense model
[hf:HuggingFaceTB/SmolLM-135M].

30L, d_model=576, 9 heads (GQA kv=3), d_ff=1536, vocab=49152.
"""

from repro_torch.common.config import AttentionConfig, LookaheadConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    num_layers=30,
    d_model=576,
    d_ff=1536,
    vocab_size=49152,
    attn=AttentionConfig(num_heads=9, num_kv_heads=3, head_dim=64),
    source="hf:HuggingFaceTB/SmolLM-135M",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke", arch_type="dense", num_layers=2, d_model=96,
        d_ff=256, vocab_size=512,
        attn=AttentionConfig(num_heads=3, num_kv_heads=1, head_dim=32),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
    )
