"""Checkpoints of the port (its own copy of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
