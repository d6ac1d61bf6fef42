"""Architecture registry of the port: ``--arch <id>`` resolves here.

Lists every architecture of the JAX package's registry, in its order: the
decoder-only ``dense`` and ``moe`` families, the ``ssm`` and ``hybrid``
families, the ``audio`` encoder-decoder and the ``vlm`` backbone, each with
its own module holding the published config and a reduced smoke config
(copies of ``repro.configs``' modules). llama3-405b and qwen1.5-110b need
the sharding layer (``parallel/``) to train or serve at full depth; on one
card they run cut in depth, and whole only as ``launch.dryrun``'s
reckoning.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "llama3-405b": "llama3_405b",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-130m": "mamba2_130m",
}
ARCH_IDS = list(_MODULES)

def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def runnable_cells() -> Dict[str, Tuple[str, ...]]:
    """(arch -> shapes) skip matrix: ``long_500k`` only for the
    sub-quadratic architectures, as in the reference."""
    out = {}
    for arch in ARCH_IDS:
        shapes = ["train_4k", "prefill_32k", "decode_32k"]
        if get_config(arch).subquadratic:
            shapes.append("long_500k")
        out[arch] = tuple(shapes)
    return out
