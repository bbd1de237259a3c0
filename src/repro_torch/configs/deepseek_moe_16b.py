"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6
[arXiv:2401.06066].

28L, d_model=2048, 16 heads (kv=16, i.e. MHA), per-expert d_ff=1408,
vocab=102400.  (Deviation noted in DESIGN.md: the real model's layer 0 is a
dense FFN; we keep all layers MoE for scan-uniform depth.)  Lookahead LoRA
restricted to attention + shared experts (routed experts stay untouched).
"""

from repro_torch.common.config import (AttentionConfig, LookaheadConfig,
                                       ModelConfig, MoEConfig)

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    d_ff=1408,
    vocab_size=102400,
    attn=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2),
    lookahead=LookaheadConfig(
        lora_targets=("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")),
    tie_embeddings=False,
    fsdp=True,
    source="arXiv:2401.06066 (DeepSeekMoE)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-smoke", arch_type="moe", num_layers=2, d_model=128,
        d_ff=64, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      num_shared_experts=1),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
        tie_embeddings=False,
    )
