"""Where the port's entry points run, and on which backend."""
from __future__ import annotations

from typing import Optional

import torch

#: ``"cuda"`` launches the hand-written kernels, ``"torch"`` runs their
#: plain versions (``kernels/skipper_match/ref.py``) on any device
BACKENDS = ("cuda", "torch")


def resolve_device(device, default, entry_point: str) -> torch.device:
    """``device``, or ``default`` when it is ``None``; a CUDA device
    without CUDA raises, naming ``entry_point``."""
    device = torch.device(default if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device: {entry_point} runs on the card unless it is "
            "given the CPU")
    return device


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """``None`` -> ``"cuda"`` on a CUDA device, ``"torch"`` elsewhere;
    an unknown name, or ``"cuda"`` off a CUDA device, raises
    ``ValueError``."""
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' launches CUDA kernels and needs CUDA tensors; "
            f"got {device} tensors (use backend='torch' on the CPU)")
    return backend
