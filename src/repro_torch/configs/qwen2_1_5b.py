"""qwen2-1.5b — GQA with QKV bias [arXiv:2407.10671].

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
"""

from repro_torch.common.config import AttentionConfig, LookaheadConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    num_layers=28,
    d_model=1536,
    d_ff=8960,
    vocab_size=151936,
    attn=AttentionConfig(num_heads=12, num_kv_heads=2, head_dim=128,
                         qkv_bias=True, rope_theta=1e6),
    source="arXiv:2407.10671 (Qwen2)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", arch_type="dense", num_layers=2, d_model=128,
        d_ff=256, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32,
                             qkv_bias=True),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
    )
