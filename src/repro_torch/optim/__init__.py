"""Optimizer of the port (its own copy of ``repro.optim``)."""
from repro_torch.optim.adamw import (
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    cosine_lr,
    init_state,
)

__all__ = ["AdamWState", "init_state", "apply_updates", "cosine_lr",
           "clip_by_global_norm"]
