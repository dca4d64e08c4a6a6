"""Architecture registry of the port: the reference's names.

`get_arch` serves the four dense, the two moe, the ssm, the hybrid, the
audio and the vlm configs (copies of `repro.configs`).
`input_specs` (jax.ShapeDtypeStruct stand-ins for the dry run) has no
counterpart: the port runs, it does not lower.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "granite-3-8b": "granite_3_8b",
    "mistral-large-123b": "mistral_large_123b",
    "yi-9b": "yi_9b",
    "granite-3-2b": "granite_3_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-130m": "mamba2_130m",
    "whisper-tiny": "whisper_tiny",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
}

ARCH_NAMES = ["moonshot-v1-16b-a3b", "granite-moe-1b-a400m", "zamba2-2.7b",
              "granite-3-8b", "mistral-large-123b", "yi-9b", "granite-3-2b",
              "mamba2-130m", "whisper-tiny", "phi-3-vision-4.2b"]


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.ARCH


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
