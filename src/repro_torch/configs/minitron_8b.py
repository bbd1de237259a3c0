"""minitron-8b — width-pruned Nemotron-4 [arXiv:2407.14679].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
"""

from repro_torch.common.config import AttentionConfig, LookaheadConfig, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    d_ff=16384,
    vocab_size=256000,
    attn=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128),
    tie_embeddings=False,
    fsdp=True,
    source="arXiv:2407.14679 (Minitron)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke", arch_type="dense", num_layers=2, d_model=128,
        d_ff=512, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=32),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
        tie_embeddings=False,
    )
