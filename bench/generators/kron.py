"""Graph500's Kronecker (R-MAT) generator, on the card.

``2**scale`` vertices and ``edge_factor * 2**scale`` edges. Each edge picks
one quadrant per bit of its endpoints with probabilities A, B, C and
D = 1 - A - B - C, as the Graph500 specification's generator (and GAPBS
``kron``) does; then the vertex labels are permuted. Repeated edges and
self-loops stay, as in Graph500's edge list. Every bit draws two uniform
coins for all edges in one call each.
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
    a, b, c = (float(config[k]) for k in ("a", "b", "c"))
    ab = a + b
    a_norm = a / ab          # P(v bit 0 | u bit 0)
    c_norm = c / (1.0 - ab)  # P(v bit 0 | u bit 1)
    g = generator(device, seed)
    u = torch.zeros(m, dtype=torch.int32, device=device)
    v = torch.zeros(m, dtype=torch.int32, device=device)
    for bit in range(scale):
        u_bit = torch.rand(m, generator=g, device=device) > ab
        coin = torch.rand(m, generator=g, device=device)
        v_bit = torch.where(u_bit, coin > c_norm, coin > a_norm)
        u |= u_bit.to(torch.int32) << bit
        v |= v_bit.to(torch.int32) << bit
        del u_bit, coin, v_bit
    if config.get("permute_labels", True):
        perm = torch.randperm(n, generator=g, device=device,
                              dtype=torch.int32)
        u = perm[u.long()]
        v = perm[v.long()]
    return Graph(u.contiguous(), v.contiguous(), n)
