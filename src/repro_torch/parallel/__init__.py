"""Sharding rules and collectives of the port (port of
``repro.parallel``)."""
from repro_torch.parallel.sharding import (
    AxisRules,
    rules_for_mesh,
    param_shardings,
    constrain,
)
from repro_torch.parallel.collectives import compressed_psum

__all__ = [
    "AxisRules",
    "rules_for_mesh",
    "param_shardings",
    "constrain",
    "compressed_psum",
]
