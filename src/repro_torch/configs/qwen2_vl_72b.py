"""qwen2-vl-72b — VLM language backbone with M-RoPE, dynamic resolution
[arXiv:2409.12191].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=29568, vocab=152064.  The vision
encoder (ViT) is stubbed per the assignment carve-out: ``input_specs``
provides pre-projected patch embeddings (B, S, D); M-RoPE positions arrive as
a (3, B, S) stream (temporal/height/width).
"""

from repro_torch.common.config import AttentionConfig, LookaheadConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152064,
    attn=AttentionConfig(num_heads=64, num_kv_heads=8, head_dim=128,
                         qkv_bias=True, rope_theta=1e6, mrope=True,
                         mrope_sections=(16, 24, 24)),
    embeds_in=True,
    tie_embeddings=False,
    fsdp=True,
    source="arXiv:2409.12191 (Qwen2-VL)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", arch_type="vlm", num_layers=2, d_model=128,
        d_ff=256, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32,
                             qkv_bias=True, mrope=True,
                             mrope_sections=(4, 6, 6)),
        embeds_in=True,
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
        tie_embeddings=False,
    )
