"""Architecture registry of the port: ``--arch <id>`` resolves here.

Lists only the architectures the port serves: four of the decoder-only
``dense`` and ``moe`` families, each with its own module holding the
published config and a reduced smoke config (copies of ``repro.configs``'
modules). Any other architecture of the JAX package's registry raises
``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
}
ARCH_IDS = list(_MODULES)

#: architectures of the JAX package the port lacks, and why
NOT_PORTED = {
    "qwen2-vl-2b": "its family (vlm) is not ported yet",
    "whisper-large-v3": "its family (audio) is not ported yet",
    "zamba2-2.7b": "its family (hybrid) is not ported yet",
    "mamba2-130m": "its family (ssm) is not ported yet",
    "llama3-405b": "no path of the port serves it yet, so its config is "
                   "not copied",
    "qwen1.5-110b": "no path of the port serves it yet, so its config is "
                    "not copied",
}


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: {NOT_PORTED[arch]} (ROADMAP queue 1, item 12: the "
            f"LM substrate); the port has {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
