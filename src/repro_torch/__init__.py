"""repro_torch — the PyTorch / CUDA port of the `repro` neuromorphic-chip
simulator, for NVIDIA Hopper cards.

The subpackages mirror `repro`'s layout (`core/`, `compiler/`,
`kernels/`, `configs/`) so each module's counterpart is found by name.
The port imports torch and numpy only, never jax and never `repro`.

Device policy: entry points run on `"cuda"` unless the caller passes
`device="cpu"`; without a card they raise (`device.resolve_device`).
TF32 is off for matmuls and convolutions, because the reference computes
full-f32 dots.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.core.quant import (CodebookConfig, QuantizedTensor,  # noqa: E402
                                    quantize)
from repro_torch.core.plasticity import (NULL_PLASTICITY,  # noqa: E402
                                         PlasticityConfig)
from repro_torch.core.soc import ChipSimulator  # noqa: E402
from repro_torch.convert import (convert, convert_adamw,  # noqa: E402
                                 convert_lm, convert_params)

__all__ = ["NULL_PLASTICITY", "ChipSimulator", "CodebookConfig",
           "PlasticityConfig", "QuantizedTensor", "convert", "convert_adamw",
           "convert_lm", "convert_params", "quantize", "resolve_device"]
