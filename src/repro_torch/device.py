"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device, default, entry_point: str) -> torch.device:
    """``device``, or ``default`` when it is ``None``; a CUDA device
    without CUDA raises, naming ``entry_point``."""
    device = torch.device(default if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: {entry_point} runs on the card unless it is "
            "given the CPU")
    return device
