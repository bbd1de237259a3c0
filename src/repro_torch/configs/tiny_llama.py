"""tiny-llama — ~100M llama-family model for the end-to-end training example
(examples/train_e2e.py): trains LookaheadKV modules for a few hundred steps
on CPU."""

from repro_torch.common.config import AttentionConfig, LookaheadConfig, ModelConfig

CONFIG = ModelConfig(
    name="tiny-llama",
    arch_type="dense",
    num_layers=12,
    d_model=768,
    d_ff=2048,
    vocab_size=32000,
    attn=AttentionConfig(num_heads=12, num_kv_heads=4, head_dim=64),
    lookahead=LookaheadConfig(n_lookahead=32, lora_rank=8),
    source="llama-family ~100M (this repo)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tiny-llama-smoke", arch_type="dense", num_layers=2, d_model=128,
        d_ff=256, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=32),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
    )
