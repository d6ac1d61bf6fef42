"""Deterministic graph generators used by tests and benchmarks.

The paper evaluates on web / social / bio / synthetic (Graph500 RMAT) graphs.
We cannot ship 224-billion-edge crawls; we reproduce the *structural families*:

* ``rmat_graph``       — Graph500-style RMAT (the paper's g500 dataset family);
                         skewed, high-locality-violating degree distribution.
* ``erdos_renyi_graph``— uniform random (low-locality baseline).
* ``grid_graph``       — 2-D lattice (high-locality; consecutive-id neighbors),
                         the adversarial case for the thread-dispersed scheduler.
* ``ring_graph`` / ``path_graph`` / ``star_graph`` — worst cases for greedy
                         matching and conflict behaviour.

All generators are numpy-based (host-side data pipeline work, as loading is in
the real system) and deterministic given ``seed``. Port of
``repro.graphs.generators``: the same numpy calls in the same order, so a
seed gives bit-identical edges; the result holds CPU int32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.types import EdgeList


def _as_edgelist(u: np.ndarray, v: np.ndarray, n: int) -> EdgeList:
    return EdgeList(torch.from_numpy(np.asarray(u, np.int32)),
                    torch.from_numpy(np.asarray(v, np.int32)), int(n))


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    permute: bool = True,
) -> EdgeList:
    """Graph500 RMAT generator (Murphy et al., "Introducing the Graph 500").

    ``2**scale`` vertices, ``edge_factor * 2**scale`` edges. Probabilities
    (a,b,c,d) follow the Graph500 spec defaults.
    """
    n = 1 << scale
    m = edge_factor * n
    rng = np.random.default_rng(seed)
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for bit in range(scale):
        coin1 = rng.random(m)
        coin2 = rng.random(m)
        u_bit = coin1 > ab
        v_bit = np.where(
            u_bit, coin2 > c_norm, coin2 > a_norm
        )
        u |= u_bit.astype(np.int64) << bit
        v |= v_bit.astype(np.int64) << bit
    if permute:
        perm = rng.permutation(n)
        u = perm[u]
        v = perm[v]
    return _as_edgelist(u.astype(np.int32), v.astype(np.int32), n)


def erdos_renyi_graph(num_vertices: int, num_edges: int, seed: int = 0) -> EdgeList:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    v = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    return _as_edgelist(u, v, num_vertices)


def grid_graph(rows: int, cols: int) -> EdgeList:
    """2-D lattice with row-major vertex ids — maximal locality."""
    idx = np.arange(rows * cols, dtype=np.int64).reshape(rows, cols)
    right_u = idx[:, :-1].ravel()
    right_v = idx[:, 1:].ravel()
    down_u = idx[:-1, :].ravel()
    down_v = idx[1:, :].ravel()
    u = np.concatenate([right_u, down_u])
    v = np.concatenate([right_v, down_v])
    return _as_edgelist(u, v, rows * cols)


def ring_graph(num_vertices: int) -> EdgeList:
    u = np.arange(num_vertices, dtype=np.int64)
    v = (u + 1) % num_vertices
    return _as_edgelist(u, v, num_vertices)


def path_graph(num_vertices: int) -> EdgeList:
    u = np.arange(num_vertices - 1, dtype=np.int64)
    return _as_edgelist(u, u + 1, num_vertices)


def star_graph(num_leaves: int) -> EdgeList:
    """Vertex 0 connected to all others. MM size is exactly 1 — every edge
    conflicts on the hub, the adversarial case for parallel matchers."""
    u = np.zeros(num_leaves, dtype=np.int64)
    v = np.arange(1, num_leaves + 1, dtype=np.int64)
    return _as_edgelist(u, v, num_leaves + 1)

