"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060].

24L, d_model=768, d_ff=0 (no MLP block: Mamba-2 blocks only), vocab=50280,
ssm_state=128.  The paper's KV-eviction technique is inapplicable (no KV
cache; constant-size recurrent state) — built without it per DESIGN.md §5.
"""

from repro_torch.common.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=128),
    lookahead=None,
    technique_applies=False,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", arch_type="ssm", num_layers=2, d_model=128,
        d_ff=0, vocab_size=512,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=32, chunk_size=32),
        lookahead=None, technique_applies=False,
    )
