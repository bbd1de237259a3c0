"""Model / technique / run configuration of the PyTorch port.

A field-for-field copy of the JAX package's ``common/config.py`` (stdlib
only): the port imports nothing of the JAX package, so it keeps its own
copy, and ``tests/test_torch_imports.py`` holds the two equal.  Every
architecture is one frozen ``ModelConfig`` (see ``repro_torch.configs``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    """Multi-head (grouped-query) attention settings."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # 0 => full attention.  >0 => sliding-window span (causal, local).
    sliding_window: int = 0
    # 0 => homogeneous layers.  n => every n-th layer (index % n == n-1) is a
    # *global* full-attention layer while the rest are sliding-window local
    # layers (gemma3's 5:1 pattern => global_every=6).
    global_every: int = 0
    # Explicit global-attention layer indices (hymba: first/middle/last);
    # overrides global_every when non-empty.
    global_layers: Tuple[int, ...] = ()
    # Multimodal rotary embedding (qwen2-vl): 3 position streams
    # (temporal, height, width) interleaved across the head dim.
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class MoEConfig:
    """Fine-grained mixture-of-experts FFN (DeepSeek-MoE / Phi-3.5-MoE)."""

    num_experts: int
    top_k: int
    d_expert: int  # per-expert hidden width
    num_shared_experts: int = 0
    router_noise: float = 0.0
    load_balance_coef: float = 0.01

    # Dry-run/serving: dense one-hot dispatch => fixed shapes, expert-parallel
    # friendly.  Capacity factor bounds per-expert tokens when using the
    # gather-based dispatch path.
    capacity_factor: float = 1.25
    # "dense": every expert runs on every token (paper-faithful baseline,
    # E/k x extra FLOPs).  "sparse": sort-based capacity dispatch (top-k
    # FLOPs only) — the §Perf beyond-paper optimization.
    dispatch: str = "dense"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (state-space duality) settings."""

    d_state: int
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 128
    dt_min: float = 1e-3
    dt_max: float = 1e-1
    a_init_range: Tuple[float, float] = (1.0, 16.0)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style bidirectional encoder (frontend stubbed: we consume
    precomputed frame embeddings of shape (B, num_frames, d_model))."""

    num_layers: int
    num_frames: int = 1500


@dataclass(frozen=True)
class LookaheadConfig:
    """The paper's technique: learnable lookahead tokens + selective LoRA."""

    n_lookahead: int = 32
    lora_rank: int = 8
    lora_alpha: float = 32.0
    # Which linear layers receive lookahead LoRA.  The paper's best config is
    # "all"; MoE archs restrict to attention projections (see DESIGN.md §5).
    lora_targets: Tuple[str, ...] = (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
    )
    # Eviction-time score post-processing (paper defaults).
    pool_kernel: int = 7
    # Observation-window size used by the SnapKV/LAQ/SpecKV baselines.
    window_size: int = 32


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture, assigned from the public pool."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    lookahead: Optional[LookaheadConfig] = field(default_factory=LookaheadConfig)

    # hybrid (hymba): run attention AND ssm in parallel inside each block.
    hybrid: bool = False
    # vlm (qwen2-vl): inputs arrive as patch/frame embeddings, not token ids.
    embeds_in: bool = False

    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    # Citation for the architecture definition (paper/model card).
    source: str = ""
    # Whether the paper's eviction technique applies (DESIGN.md §5).
    technique_applies: bool = True
    # FSDP-style extra sharding of frozen weights over the data axis for
    # large models (beyond-paper distribution feature).
    fsdp: bool = False
    # Embedding/lm-head rows are padded to this multiple so the vocab dim
    # always shards on "model" (§Perf: an unshardable vocab forces a full
    # (B,S,V) f32 logits all-reduce — 13 GB/device for mamba2 train_4k).
    vocab_pad_multiple: int = 256

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m if m else self.vocab_size

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    @property
    def uses_attention(self) -> bool:
        return self.attn is not None

    @property
    def uses_ssm(self) -> bool:
        return self.ssm is not None

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L = self.d_model, self.num_layers
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        per_layer = 0
        if self.attn is not None:
            a = self.attn
            per_layer += d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
            if a.qkv_bias:
                per_layer += a.q_dim + 2 * a.kv_dim
        if self.ssm is not None:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            # in_proj -> (z, x, B, C, dt), conv, A, D, norm, out_proj
            # (B/C are group-shared: ngroups=1, NOT per-head)
            per_layer += d * (2 * di + 2 * s.d_state + nh)
            per_layer += s.conv_width * di
            per_layer += 2 * nh + di  # A_log, D, gated-norm
            per_layer += di * d
        if self.moe is not None:
            m = self.moe
            per_layer += d * m.num_experts  # router
            per_layer += m.num_experts * 3 * d * m.d_expert
            per_layer += m.num_shared_experts * 3 * d * m.d_expert
        elif self.d_ff > 0:
            per_layer += 3 * d * self.d_ff
        per_layer += 2 * d  # norms
        total += L * per_layer
        if self.encoder is not None:
            a = self.attn
            enc_layer = d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
            enc_layer += 3 * d * self.d_ff + 2 * d
            # decoder cross-attention
            total += self.encoder.num_layers * enc_layer
            total += L * (d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d + d)
        total += d  # final norm
        return total

    def active_params(self) -> int:
        """Activated parameters per token (MoE-aware), for MODEL_FLOPS."""
        if self.moe is None:
            return self.num_params()
        d, L, m = self.d_model, self.num_layers, self.moe
        routed_total = L * m.num_experts * 3 * d * m.d_expert
        routed_active = L * m.top_k * 3 * d * m.d_expert
        return self.num_params() - routed_total + routed_active

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Run / eviction configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EvictionConfig:
    policy: str = "lookaheadkv"
    budget: int = 128
    # StreamingLLM sink size.
    sink: int = 4
    # LAQ / SpecKV draft length (paper: equal to n_lookahead).
    draft_len: int = 32
    # PyramidKV: budgets decay linearly from first to last layer with this
    # total preserved (beta=20-ish funnel in the paper; linear here).
    pyramid_beta: float = 2.0
    # Encoder-decoder extension (beyond-paper): also evict the *cross*
    # attention KV (encoder frames) down to this budget, scored by the same
    # lookahead/observation queries.  0 = keep the full encoder cache.
    cross_budget: int = 0
    # "uniform": every kv head keeps ``budget`` slots.  "adaptive": Ada-KV
    # style — the global pool KV·budget redistributes toward heads whose
    # score mass concentrates (beyond-paper composable axis).
    head_alloc: str = "uniform"
    # Ada-KV ceiling multiplier: per-head capacity = ceil(budget · this).
    adaptive_ceiling: float = 2.0


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    n_in: int = 3_584
    n_out: int = 512
    steps: int = 200
    lr: float = 1e-3
    warmup_frac: float = 0.02
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0
