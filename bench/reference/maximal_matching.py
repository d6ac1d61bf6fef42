"""The plain reference of the matcher: what a maximal matching is.

A matcher's answer is an edge mask in stream order and a vertex state in
the graph's own ids. It is right when (paper §II-B and Alg. 1):

* the mask has one entry per edge and the state one per vertex;
* no vertex is an endpoint of two selected edges, and no self-loop or
  invalid edge is selected (validity);
* every valid edge has a selected edge at one of its endpoints
  (maximality);
* a vertex's state is MCHD (2) where a selected edge covers it and ACC (0)
  elsewhere: the one byte a vertex that the matcher keeps.

Many masks are maximal matchings of one graph, and the matcher's order
picks one, so the reference checks the answer against the definition and
does not compute one of its own. Every number it returns counts offences
and its limit is 0: an exact comparison. Plain PyTorch on the answer's
device; it imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import torch

ACC = 0
MCHD = 2

#: every number the check returns, with its limit
LIMITS = {"shape_off": 0, "invalid": 0, "uncovered": 0, "state_off": 0}


def check(u: torch.Tensor, v: torch.Tensor, n: int, mask: torch.Tensor,
          state: torch.Tensor) -> Dict[str, int]:
    """Offences of ``(mask, state)`` as an answer for the stream ``(u, v)``
    of ``n`` vertices, as Python ints keyed as :data:`LIMITS`."""
    dev = u.device
    m = int(u.shape[0])
    mask = mask.to(dev).reshape(-1)
    state = state.to(dev).reshape(-1)
    if mask.shape[0] != m or state.shape[0] != n:
        return {"shape_off": abs(int(mask.shape[0]) - m)
                + abs(int(state.shape[0]) - n),
                "invalid": 0, "uncovered": 0, "state_off": 0}
    mask = mask.bool()
    valid = (u != v) & (u >= 0) & (v >= 0) & (u < n) & (v < n)
    chosen = mask & valid
    uu = torch.where(valid, u, 0).long()
    vv = torch.where(valid, v, 0).long()
    # selected-edge ends at each vertex; an invalid edge adds to no vertex
    ends = torch.zeros(n, dtype=torch.int64, device=dev)
    ones = chosen.to(torch.int64)
    ends.index_add_(0, uu, ones)
    ends.index_add_(0, vv, ones)
    covered = ends > 0
    invalid = int((ends > 1).sum()) + int((mask & ~valid).sum())
    uncovered = int((valid & ~covered[uu] & ~covered[vv]).sum())
    want = torch.where(covered, MCHD, ACC).to(torch.int64)
    state_off = int((state.to(torch.int64) != want).sum())
    return {"shape_off": 0, "invalid": invalid, "uncovered": uncovered,
            "state_off": state_off}
