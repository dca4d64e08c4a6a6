"""Architecture registry + input specs for every (arch x shape) cell.

`get_arch` serves the four dense, the two moe, the ssm, the hybrid, the
audio and the vlm configs (copies of `repro.configs`).
`input_specs(cfg, shape)` returns meta-device tensors standing for every
model input of a cell — the reference's shapes and types, nothing
allocated — which the dry run traces against (`launch/dryrun.py`).
"""
from __future__ import annotations

import importlib

import torch

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


def cell_is_runnable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Which (arch x shape) cells run: long_500k needs a sub-quadratic
    path."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k needs sub-quadratic attention (ssm/hybrid only)"
    return True, ""


def runnable_cells(smoke: bool = False):
    out = []
    for a in ARCH_NAMES:
        cfg = get_arch(a, smoke)
        for s in SHAPES.values():
            ok, why = cell_is_runnable(cfg, s)
            out.append((a, s.name, ok, why))
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor batch stand-ins for one cell.

    train:   tokens/labels (B, S) int32  (+frames / patch_embeds stubs)
    prefill: tokens (B, S) int32         (+stubs)
    decode:  tokens (B, 1) int32; the KV/SSM caches are created separately
             by the launcher (`transformer.init_decode_state`).
    """
    b, s = shape.global_batch, shape.seq_len

    def t(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        text_len = s - cfg.n_patches if cfg.family == "vlm" else s
        batch = {"tokens": t((b, text_len))}
        if shape.kind == "train":
            batch["labels"] = t((b, text_len))
        if cfg.family == "audio":
            batch["frames"] = t((b, cfg.enc_frames, cfg.d_model),
                                torch.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = t((b, cfg.n_patches, cfg.d_model),
                                      torch.float32)
        return batch
    if shape.kind == "decode":
        return {"tokens": t((b, 1))}
    raise ValueError(shape.kind)
