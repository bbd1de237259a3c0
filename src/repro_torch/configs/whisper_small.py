"""whisper-small — encoder-decoder, conv/mel frontend stubbed
[arXiv:2212.04356].

12 encoder + 12 decoder layers, d_model=768, 12 heads (kv=12), d_ff=3072,
vocab=51865.  ``input_specs`` provides precomputed 1500-frame embeddings
(B, 1500, 768) in place of the mel-spectrogram + conv feature extractor
(assignment carve-out).  Decoder self-attention uses RoPE instead of learned
absolute positions so the 32k decode shapes are well-posed.  The eviction
technique applies to the decoder self-attn cache; ``EvictionConfig.
cross_budget`` evicts the encoder (cross-attention) cache too.
"""

from repro_torch.common.config import (AttentionConfig, EncoderConfig,
                                       LookaheadConfig, ModelConfig)

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,
    d_model=768,
    d_ff=3072,
    vocab_size=51865,
    attn=AttentionConfig(num_heads=12, num_kv_heads=12, head_dim=64),
    encoder=EncoderConfig(num_layers=12, num_frames=1500),
    act="gelu",
    source="arXiv:2212.04356 (Whisper)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", arch_type="audio", num_layers=2, d_model=128,
        d_ff=256, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=32),
        encoder=EncoderConfig(num_layers=2, num_frames=16),
        act="gelu",
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
    )
