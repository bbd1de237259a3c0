"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)``.

The port serves the paper's llama family and the SSM archs (the hybrid
hymba-1.5b, the attention-free mamba2-130m).  Every other architecture of
the JAX package's registry raises ``KeyError`` naming the ROADMAP item
that brings it to the port.
"""

from __future__ import annotations

import importlib

from repro_torch.common.config import ModelConfig

_MODULES = {
    "llama3-8b": "llama3_8b",
    "tiny-llama": "tiny_llama",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-130m": "mamba2_130m",
}

# arch id -> ROADMAP item that ports it
_LATER = {
    "smollm-135m": "ROADMAP A10 (other dense archs)",
    "qwen2-1.5b": "ROADMAP A10 (other dense archs)",
    "minitron-8b": "ROADMAP A10 (other dense archs)",
    "gemma3-1b": "ROADMAP A10 (sliding-window archs)",
    "deepseek-moe-16b": "ROADMAP A10 (MoE archs)",
    "phi3.5-moe-42b-a6.6b": "ROADMAP A10 (MoE archs)",
    "qwen2-vl-72b": "ROADMAP A10 (VLM and audio archs)",
    "whisper-small": "ROADMAP A10 (VLM and audio archs)",
}


def _module(arch_id: str):
    if arch_id in _LATER:
        raise KeyError(f"arch '{arch_id}' is not ported yet: {_LATER[arch_id]}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
