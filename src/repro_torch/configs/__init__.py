"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)``.

The port serves the paper's llama family, the other dense archs
(smollm-135m, qwen2-1.5b with its qkv bias, minitron-8b, and gemma3-1b
with its 5:1 local:global layers and head dim 256), the MoE archs
(deepseek-moe-16b, phi3.5-moe-42b-a6.6b), qwen2-vl-72b's language
backbone (M-RoPE, embedding inputs), the SSM archs (the hybrid
hymba-1.5b, the attention-free mamba2-130m) and the encoder-decoder
whisper-small (stubbed frame embeddings, cross-attention): every arch of
the JAX package's registry.
"""

from __future__ import annotations

import importlib

from repro_torch.common.config import ModelConfig

#: the assigned archs (the JAX package's ``ARCH_IDS``), in its order
ARCH_IDS = (
    "mamba2-130m",
    "smollm-135m",
    "deepseek-moe-16b",
    "phi3.5-moe-42b-a6.6b",
    "minitron-8b",
    "qwen2-vl-72b",
    "gemma3-1b",
    "qwen2-1.5b",
    "whisper-small",
    "hymba-1.5b",
)

_MODULES = {
    "llama3-8b": "llama3_8b",
    "tiny-llama": "tiny_llama",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-130m": "mamba2_130m",
    "smollm-135m": "smollm_135m",
    "qwen2-1.5b": "qwen2_1_5b",
    "minitron-8b": "minitron_8b",
    "gemma3-1b": "gemma3_1b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-small": "whisper_small",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


def shape_applicable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason): the long_500k skip matrix.  Archs whose cache a
    constant state or a sliding window bounds take it; pure full-attention
    archs skip it (a 524k-token decode cache of quadratic history)."""
    cfg = get_config(arch_id)
    if shape_name != "long_500k":
        return True, ""
    if cfg.uses_ssm:  # mamba2, hymba
        return True, "ssm/hybrid: constant state + windowed attention"
    if cfg.attn is not None and (cfg.attn.sliding_window > 0):
        return True, "sliding-window attention bounds per-layer cache"
    return False, (
        "pure full-attention arch: 524k decode cache is quadratic-history; "
        "skipped per spec (DESIGN.md §5)"
    )
