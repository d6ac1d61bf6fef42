"""GAPBS's uniform random graph (``urand``, G(n, m)), on the card.

``2**scale`` vertices and ``edge_factor * 2**scale`` edges, each endpoint
drawn uniformly and independently. Repeated edges and self-loops stay in
the stream, as the generator emits them.
"""
from __future__ import annotations

import torch

from bench.generators import Graph, generator


def generate(config: dict, seed: int, device: torch.device) -> Graph:
    scale = int(config["scale"])
    if not 1 <= scale <= 30:
        raise ValueError(f"scale {scale} out of [1, 30] (int32 ids)")
    n = 1 << scale
    m = int(config["edge_factor"]) * n
    g = generator(device, seed)
    u = torch.randint(0, n, (m,), generator=g, device=device,
                      dtype=torch.int32)
    v = torch.randint(0, n, (m,), generator=g, device=device,
                      dtype=torch.int32)
    return Graph(u, v, n)
