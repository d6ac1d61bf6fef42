"""The benchmark's own input generators, on the card, from ``--seed``.

A configuration names its generator by ``"generator"``; the module of
that name here has ``generate(config, seed, device) -> Graph``. The same
seed on the same device gives the same edges. Every generator draws from
one ``torch.Generator`` on ``device``, in a few large calls.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """An edge stream: ``u``, ``v`` int32 tensors of equal length on one
    device, ``n`` vertices. Self-loops and repeated edges stay in the
    stream, as a generator emits them."""

    u: torch.Tensor
    v: torch.Tensor
    n: int

    @property
    def m(self) -> int:
        return int(self.u.shape[0])


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any int a signed or
    unsigned 64-bit seed holds)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def generate(config: dict, seed: int, device) -> Graph:
    """The graph of ``config`` for ``seed``, through the generator it
    names."""
    mod = importlib.import_module(f"bench.generators.{config['generator']}")
    return mod.generate(config, seed, torch.device(device))
