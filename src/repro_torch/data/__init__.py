"""Data pipeline of the port (its own copy of ``repro.data``)."""
from repro_torch.data.packing import pack_documents, packing_efficiency
from repro_torch.data.pipeline import (
    DataConfig,
    batch_for_step,
    documents_for_step,
    stream,
)

__all__ = [
    "DataConfig",
    "batch_for_step",
    "stream",
    "documents_for_step",
    "pack_documents",
    "packing_efficiency",
]
