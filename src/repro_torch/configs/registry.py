"""Architecture registry of the port: ``--arch <id>`` resolves here.

Lists the architectures the port runs: the decoder-only ``dense`` and
``moe`` families, the ``ssm`` and ``hybrid`` families, the ``audio``
encoder-decoder and the ``vlm`` backbone, each with its own module holding
the published config and a reduced smoke config (copies of
``repro.configs``' modules). The two architectures of the JAX package's
registry that need sharding across cards raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig

_MODULES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-vl-2b": "qwen2_vl_2b",
}
ARCH_IDS = list(_MODULES)

#: architectures of the JAX package the port lacks, and why
NOT_PORTED = {
    "llama3-405b": "the port has no sharding for it, so its config is not "
                   "copied",
    "qwen1.5-110b": "the port has no sharding for it, so its config is not "
                    "copied",
}


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: {NOT_PORTED[arch]} (ROADMAP queue 1, item 12.3: "
            f"parallel/); the port has {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
