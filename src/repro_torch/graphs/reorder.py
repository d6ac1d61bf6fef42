"""Locality-aware vertex reordering — the windowed pipeline's front door.

The device-resident pipeline (`kernels/skipper_match/ops.py`) only pays off
when edges land *inside* a vertex window: permuted RMAT leaves ~13% of edges
intra-window at window=2048, so most work used to fall through to the serial
boundary epilogue (benchmarks/baseline_small.json, DESIGN.md §2 A7). The
paper's locality phase assumes the input order concentrates work; Birn et
al. (*Efficient Parallel and External Matching*) make the same point for
cache-local edge orders. This module makes that a first-class, measured
subsystem: renumber vertices so that edge endpoints cluster into windows,
run the pipeline in the renumbered space, and map results back.

Three pluggable policies (all host/numpy one-shot precompute, like the
window schedule itself):

* ``degree`` — bucket vertices by descending degree. RMAT/power-law hubs are
  rich-club connected (hub-hub edges dominate), so packing hubs into the
  same windows recovers most of the structure the Graph500 permutation
  destroyed. O(V + E), the default. Measured: rmat14 intra 0.13 -> ~0.68.
* ``bfs``    — breadth-first clustering from highest-degree unvisited roots;
  neighbors get nearby ids. Good for meshes/communities (grid-like inputs),
  weaker on scale-free graphs (frontiers explode past window size).
* ``greedy`` — window-affinity clustering: seed each window with the
  highest-degree unassigned vertex, then repeatedly pull in the unassigned
  vertex with the most edges into the window under construction
  (score+degree tie-break). Best intra fractions. The selection runs on a
  lazy-deletion max-heap of affinity-touched candidates merged with a
  degree-order cursor for the untouched ones — O((V + E) log E) total,
  paper-scale ready — and picks the exact vertex the old full
  O(V^2/window) host argmax picked (``_reorder_greedy_argmax``, kept as
  the test oracle, is pinned bit-identical on every generator family).

A ``Reordering`` is a bijection old->new (``perm``) with its inverse
(``inv``); ``windows.build_window_schedule(reorder=...)`` applies it before
bucketing and carries it through the schedule so ``skipper_match`` returns
results in *original* vertex ids.

Port of ``repro.graphs.reorder``: host numpy, the same selections, so every
policy's ``perm`` is array-equal to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.types import EdgeList

POLICIES = ("none", "degree", "bfs", "greedy")


@dataclasses.dataclass(frozen=True)
class Reordering:
    """Vertex renumbering: ``perm[old_id] = new_id``, ``inv[new_id] = old_id``.
    Both int32[num_vertices]; ``perm[inv] == inv[perm] == arange``."""

    policy: str
    perm: np.ndarray
    inv: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.perm.shape[0])


def _valid_endpoints(edges: EdgeList):
    u, v = edges.to_numpy()
    valid = (u >= 0) & (v >= 0) & (u != v)
    return u[valid], v[valid]


def _degrees(edges: EdgeList) -> np.ndarray:
    u, v = _valid_endpoints(edges)
    n = edges.num_vertices
    return np.bincount(u, minlength=n) + np.bincount(v, minlength=n)


def _csr_neighbors(edges: EdgeList):
    """Symmetrized CSR (starts int64[n+1], nbrs int[sum deg]) — host numpy."""
    u, v = _valid_endpoints(edges)
    n = edges.num_vertices
    su = np.concatenate([u, v])
    sv = np.concatenate([v, u])
    order = np.argsort(su, kind="stable")
    su = su[order]
    sv = sv[order]
    starts = np.searchsorted(su, np.arange(n + 1))
    return starts, sv


def _from_inverse(policy: str, inv: np.ndarray) -> Reordering:
    n = inv.shape[0]
    perm = np.empty(n, np.int64)
    perm[inv] = np.arange(n)
    return Reordering(policy, perm.astype(np.int32), inv.astype(np.int32))


def _reorder_degree(edges: EdgeList) -> Reordering:
    deg = _degrees(edges)
    inv = np.argsort(-deg, kind="stable")  # new id j <- old vertex inv[j]
    return _from_inverse("degree", inv)


def _reorder_bfs(edges: EdgeList) -> Reordering:
    from collections import deque

    n = edges.num_vertices
    deg = _degrees(edges)
    starts, nbrs = _csr_neighbors(edges)
    roots = np.argsort(-deg, kind="stable")
    visited = np.zeros(n, bool)
    inv = np.empty(n, np.int64)
    pos = 0
    for r in roots:
        if visited[r]:
            continue
        visited[r] = True
        q = deque([int(r)])
        while q:
            x = q.popleft()
            inv[pos] = x
            pos += 1
            for y in nbrs[starts[x] : starts[x + 1]]:
                if not visited[y]:
                    visited[y] = True
                    q.append(int(y))
    assert pos == n
    return _from_inverse("bfs", inv)


def _reorder_greedy_argmax(edges: EdgeList, window: int) -> Reordering:
    """Reference greedy clustering: full argmax over all vertices per pick.

    O(V^2/window) host work — kept ONLY as the test oracle pinning
    :func:`_reorder_greedy`'s heap selection (bit-identical output); the
    production path below is the scalable one.
    """
    n = edges.num_vertices
    deg = _degrees(edges)
    starts, nbrs = _csr_neighbors(edges)
    deg_order = np.argsort(-deg, kind="stable")
    # fractional degree tie-break keeps hub pull without outweighing affinity
    key = deg.astype(np.float64) / (deg.max() + 1.0) * 0.5 if n else deg
    assigned = np.zeros(n, bool)
    score = np.zeros(n, np.float64)
    inv = np.empty(n, np.int64)
    pos = 0
    seed_cursor = 0
    num_windows = -(-n // window)
    for _ in range(num_windows):
        score[:] = 0.0
        while seed_cursor < n and assigned[deg_order[seed_cursor]]:
            seed_cursor += 1
        if seed_cursor >= n:
            break
        cur = int(deg_order[seed_cursor])
        for _ in range(min(window, n - pos)):
            assigned[cur] = True
            inv[pos] = cur
            pos += 1
            np.add.at(score, nbrs[starts[cur] : starts[cur + 1]], 1.0)
            masked = np.where(assigned, -np.inf, score + key)
            cur = int(np.argmax(masked))
    assert pos == n
    return _from_inverse("greedy", inv)


def _reorder_greedy(edges: EdgeList, window: int) -> Reordering:
    """Heap-based greedy clustering, selection-identical to the argmax
    reference but O((V + E) log E).

    The argmax over ``score + key`` decomposes into two candidate pools:

    * vertices *touched* this window (``score > 0``) — kept in a
      lazy-deletion max-heap: every score increment pushes a fresh
      ``(-(score+key), v)`` entry; a popped entry is discarded when the
      vertex is assigned or its stored priority no longer equals the live
      ``score[v] + key[v]`` (per-window score resets make stale entries
      self-invalidate the same way).
    * *untouched* vertices (``score == 0``), whose priority is ``key``
      alone — monotone along the degree order, so the best one is always
      the first unassigned vertex under a monotone cursor. When that
      vertex HAS been touched it also sits in the heap with a strictly
      higher priority (score >= 1 > key), so skipping the untouched pool
      behind it never changes the argmax.

    Ties resolve to the smallest vertex id in both pools — exactly
    ``np.argmax``'s first-maximum rule — so the produced ordering is
    bit-identical to the reference (test-pinned).
    """
    import heapq

    n = edges.num_vertices
    deg = _degrees(edges)
    starts_a, nbrs_a = _csr_neighbors(edges)
    deg_order = np.argsort(-deg, kind="stable").tolist()
    keys_np = (
        deg.astype(np.float64) / (deg.max() + 1.0) * 0.5
        if n
        else deg.astype(np.float64)
    )
    key = keys_np.tolist()
    starts = starts_a.tolist()
    nbrs = nbrs_a.tolist()
    assigned = bytearray(n)
    score = [0.0] * n
    inv = np.empty(n, np.int64)
    pos = 0
    cursor = 0  # first-unassigned pointer into deg_order (seeds AND picks)
    num_windows = -(-n // window)
    for _ in range(num_windows):
        while cursor < n and assigned[deg_order[cursor]]:
            cursor += 1
        if cursor >= n:
            break
        cur = deg_order[cursor]
        heap: list = []
        touched: list = []
        for _ in range(min(window, n - pos)):
            assigned[cur] = True
            inv[pos] = cur
            pos += 1
            for y in nbrs[starts[cur] : starts[cur + 1]]:
                if assigned[y]:
                    continue
                s = score[y] + 1.0
                score[y] = s
                touched.append(y)
                heapq.heappush(heap, (-(s + key[y]), y))
            # best touched candidate (discard assigned/stale entries)
            while heap:
                p, y = heap[0]
                if assigned[y] or -p != score[y] + key[y]:
                    heapq.heappop(heap)
                    continue
                break
            while cursor < n and assigned[deg_order[cursor]]:
                cursor += 1
            if cursor >= n:
                break  # every vertex assigned — no next pick to compute
            d = deg_order[cursor]
            pd = score[d] + key[d]
            if heap:
                p, y = heap[0]
                if (-p, -y) > (pd, -d):
                    cur = y
                    continue
            cur = d
        # reset this window's scores (touched vertices only — O(touched))
        for y in touched:
            score[y] = 0.0
    assert pos == n
    return _from_inverse("greedy", inv)


def reorder_vertices(
    edges: EdgeList, policy: str, window: int = 2048
) -> Reordering:
    """Compute a locality reordering of ``edges``'s vertices.

    ``window`` is the target window size — only the ``greedy`` policy uses it
    (its clusters are window-sized by construction). ``none`` returns the
    identity (handy for uniform benchmarking code paths).
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown reorder policy {policy!r}; one of {POLICIES}")
    if policy == "none":
        ident = np.arange(edges.num_vertices, dtype=np.int32)
        return Reordering("none", ident, ident.copy())
    if policy == "degree":
        return _reorder_degree(edges)
    if policy == "bfs":
        return _reorder_bfs(edges)
    return _reorder_greedy(edges, window)


def intra_window_fraction(edges: EdgeList, window: int, reordering=None) -> float:
    """Fraction of valid edges with both endpoints in one window (diagnostic;
    the schedule reports the same number for its own build)."""
    u, v = _valid_endpoints(edges)
    if u.size == 0:
        return 1.0
    if reordering is not None:
        u = reordering.perm[u]
        v = reordering.perm[v]
    return float(np.mean(u // window == v // window))
