"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke_config(arch_id)``.

The port serves the paper's llama family, the other dense archs
(smollm-135m, qwen2-1.5b with its qkv bias, minitron-8b, and gemma3-1b
with its 5:1 local:global layers and head dim 256) and the SSM archs (the
hybrid hymba-1.5b, the attention-free mamba2-130m).  The MoE, VLM and
audio archs of the JAX package's registry raise ``KeyError`` naming the
ROADMAP item that brings them to the port.
"""

from __future__ import annotations

import importlib

from repro_torch.common.config import ModelConfig

_MODULES = {
    "llama3-8b": "llama3_8b",
    "tiny-llama": "tiny_llama",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-130m": "mamba2_130m",
    "smollm-135m": "smollm_135m",
    "qwen2-1.5b": "qwen2_1_5b",
    "minitron-8b": "minitron_8b",
    "gemma3-1b": "gemma3_1b",
}

# arch id -> ROADMAP item that ports it
_LATER = {
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
