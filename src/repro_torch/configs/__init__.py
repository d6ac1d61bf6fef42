"""Model configs of the port (its own copy of ``repro.configs``)."""
from repro_torch.configs.base import (
    ModelConfig, ShapeConfig, SHAPES, TrainConfig,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    get_config,
    get_shape,
    get_smoke_config,
    runnable_cells,
)

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "TrainConfig",
    "ARCH_IDS", "get_config", "get_smoke_config", "get_shape",
    "runnable_cells",
]
