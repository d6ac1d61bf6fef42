"""JIT-conflict accounting — the Table II analogue (port of
``repro.core.conflicts``, pure numpy, kept as its own copy).

A "JIT conflict" is an edge that was free but blocked by an earlier in-tile
claimant for one vector round: the moral equivalent of a failing CAS in
Alg. 1 lines 11/14.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]


def conflict_table(conflicts_per_edge: np.ndarray) -> Dict[str, object]:
    """Summarize a per-edge conflict-count array into the paper's Table II
    columns: max per edge, total, #edges with conflicts, avg per conflicting
    edge, and the bucketed distribution (1, 2, 3-4, 5-8, ..., >256).
    Takes a numpy array or a CPU tensor."""
    c = np.asarray(conflicts_per_edge)
    conflicting = c[c > 0]
    total = int(c.sum())
    n_edges = int(conflicting.size)
    dist: List[int] = []
    lo = 1
    for hi in _BUCKETS:
        dist.append(int(((conflicting >= lo) & (conflicting <= hi)).sum()))
        lo = hi + 1
    dist.append(int((conflicting > _BUCKETS[-1]).sum()))
    return {
        "max_cnf_per_edge": int(c.max()) if c.size else 0,
        "total_cnf": total,
        "edges_exp_cnf": n_edges,
        "avg_cnf_per_edge": (total / n_edges) if n_edges else 0.0,
        "distribution": dist,  # buckets: 1,2,3-4,5-8,9-16,...,129-256,>256
        "conflict_ratio": n_edges / max(c.size, 1),
    }
