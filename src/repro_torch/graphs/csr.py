"""COO <-> CSR conversion, symmetrization and dedup (port of
``repro.graphs.csr``).

The vertex-centric baselines of the paper need the symmetrized CSR;
Skipper itself does not (paper §V-C). Host numpy, as data loading is; the
results hold CPU int32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.types import CSRGraph, EdgeList


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def dedup_edges(edges: EdgeList, drop_self_loops: bool = True) -> EdgeList:
    """Canonicalize (u <= v), drop duplicates (and optionally self loops);
    the survivors come sorted by (u, v)."""
    u, v = edges.to_numpy()
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    if drop_self_loops:
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
    key = lo.astype(np.int64) * np.int64(edges.num_vertices) + hi
    _, idx = np.unique(key, return_index=True)
    return EdgeList(_i32(lo[idx]), _i32(hi[idx]), edges.num_vertices)


def symmetrize(edges: EdgeList) -> EdgeList:
    """The edge list with both directions present (for CSR baselines)."""
    u, v = edges.to_numpy()
    return EdgeList(_i32(np.concatenate([u, v])), _i32(np.concatenate([v, u])),
                    edges.num_vertices)


def edges_to_csr(edges: EdgeList, symmetric: bool = True) -> CSRGraph:
    """CSR of the (by default symmetrized) edge list: neighbours of each
    vertex in stream order."""
    e = symmetrize(edges) if symmetric else edges
    u, v = e.to_numpy()
    n = e.num_vertices
    order = np.argsort(u, kind="stable")
    counts = np.bincount(u[order], minlength=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return CSRGraph(_i32(offsets), _i32(v[order]), n)
