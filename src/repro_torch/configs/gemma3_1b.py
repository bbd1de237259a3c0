"""gemma3-1b — 5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt].

26L, d_model=1152, 4 heads (GQA kv=1), d_ff=6912, vocab=262144.  Every 6th
layer is global full attention; the rest use a 512-token sliding window.
head_dim=256 (explicit in the model card, != d_model/num_heads).

long_500k applicability: local layers bound their cache by the window; the
global layers decode against the *evicted budget* cache — i.e. the paper's
own technique is what makes a 524k-token decode feasible for this dense arch
(DESIGN.md §5).
"""

from repro_torch.common.config import AttentionConfig, LookaheadConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    num_layers=26,
    d_model=1152,
    d_ff=6912,
    vocab_size=262144,
    attn=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=256,
                         sliding_window=512, global_every=6, rope_theta=1e6),
    source="hf:google/gemma-3-1b-pt",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", arch_type="dense", num_layers=2, d_model=128,
        d_ff=256, vocab_size=512,
        attn=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=32,
                             sliding_window=16, global_every=2),
        lookahead=LookaheadConfig(n_lookahead=8, lora_rank=4, window_size=8,
                                  pool_kernel=3),
    )
