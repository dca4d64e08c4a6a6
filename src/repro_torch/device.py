"""Device policy of the port: the card by default, the CPU only when asked.

Every entry point takes a `device` argument and resolves it here.  There
is no silent fallback: without a CUDA card, a caller that did not ask for
the CPU gets an error, so a run that was meant for the card can never
quietly measure the CPU instead.  Under a launcher that sets
`LOCAL_RANK` (torchrun), the default card is `cuda:{LOCAL_RANK}`, taken
modulo the card count, so each rank of a process group lands on its own.
"""
from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means "cuda" (`cuda:{LOCAL_RANK % cards}` under a launcher
    that sets LOCAL_RANK).  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run the plain versions on "
            "the CPU")
    local = os.environ.get("LOCAL_RANK")
    if device is None and local is not None:
        dev = torch.device("cuda", int(local) % torch.cuda.device_count())
    return dev
