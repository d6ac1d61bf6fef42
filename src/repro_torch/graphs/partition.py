"""Edge-stream padding (port of ``repro.graphs.partition.pad_edges``).

The rest of the reference's ``partition.py`` (the dispersed and
locality-sharded deals of the distributed matcher) is not ported yet
(ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import torch

from repro_torch.graphs.types import INVALID, EdgeList


def pad_edges(edges: EdgeList, multiple: int) -> EdgeList:
    """Pad the edge arrays to a multiple of ``multiple`` with inert
    ``(INVALID, INVALID)`` self-loop sentinels, on the edges' device."""
    m = edges.num_edges
    pad = (-m) % multiple
    if pad == 0:
        return edges
    fill = torch.full((pad,), int(INVALID), dtype=torch.int32,
                      device=edges.u.device)
    return EdgeList(torch.cat([edges.u, fill]), torch.cat([edges.v, fill]),
                    edges.num_vertices)
