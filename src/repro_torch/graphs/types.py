"""The graph containers (port of ``repro.graphs.types``): the COO edge
list and the CSR graph.

Invalid (padding) edges are ``u == v == -1``; every matcher skips them, as
it skips self-loops (paper Alg. 1 lines 6-7).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

INVALID = np.int32(-1)


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """COO edge list: ``u`` and ``v`` are int32 tensors of equal length on
    one device; ``num_vertices`` is a plain int."""

    u: torch.Tensor
    v: torch.Tensor
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.u.shape[0])

    def canonical(self) -> "EdgeList":
        """Return with u <= v per edge (paper Alg. 1 lines 8-9)."""
        return EdgeList(torch.minimum(self.u, self.v),
                        torch.maximum(self.u, self.v), self.num_vertices)

    def to(self, device) -> "EdgeList":
        return EdgeList(self.u.to(device), self.v.to(device),
                        self.num_vertices)

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        # a copy to the host is what this method is for
        return self.u.cpu().numpy(), self.v.cpu().numpy()  # host-sync: ok


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed sparse row graph (paper §II-A): ``offsets`` int32[|V|+1]
    and ``neighbors`` int32[|E|] tensors; ``num_vertices`` a plain int."""

    offsets: torch.Tensor
    neighbors: torch.Tensor
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.neighbors.shape[0])

    def degree(self, v: int) -> int:
        # one vertex's degree as a Python int is what this method is for
        return int(self.offsets[v + 1] - self.offsets[v])  # host-sync: ok
