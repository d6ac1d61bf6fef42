"""Sequential Greedy Maximal Matching (SGMM) — the paper's §II-B baseline
and the correctness oracle (port of ``repro.core.sgmm``).

Iterates edges in stream order; an edge is selected iff it is valid and
both endpoints are unmarked. A plain Python loop over host arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import ACC, MCHD, STATE_DTYPE, Counters, MatchResult
from repro_torch.graphs.types import EdgeList


def sgmm(edges: EdgeList) -> MatchResult:
    """Sequential greedy matching over the edge stream (CPU tensors out)."""
    n = edges.num_vertices
    # the sequential oracle walks the stream on the host
    u, v = (a.tolist() for a in edges.canonical().to_numpy())  # host-sync: ok
    state = np.full((n,), ACC, np.uint8)  # state-dtype: ok — at-rest byte
    mask = np.zeros((len(u),), bool)
    for i, (a, b) in enumerate(zip(u, v)):
        if a != b and a >= 0 and state[a] == ACC and state[b] == ACC:
            state[a] = state[b] = MCHD
            mask[i] = True
    m = len(u)
    counters = Counters(*(torch.tensor(x, dtype=torch.int32) for x in
                          (m, 2 * m, 2 * int(mask.sum()), 1)))
    return MatchResult(match_mask=torch.from_numpy(mask),
                       state=torch.from_numpy(state).to(STATE_DTYPE),
                       counters=counters)
