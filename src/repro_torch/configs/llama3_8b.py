"""llama3.1-8b — the paper's primary subject model [arXiv:2407.21783].

Included beyond the assigned pool so the benchmarks mirror the paper's own
tables (at reduced scale on CPU via ``smoke``).
"""

from repro_torch.common.config import AttentionConfig, LookaheadConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    attn=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128,
                         rope_theta=5e5),
    tie_embeddings=False,
    fsdp=True,
    source="arXiv:2407.21783 (Llama 3 herd)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", arch_type="dense", num_layers=2, d_model=128,
        d_ff=384, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
        tie_embeddings=False,
    )
