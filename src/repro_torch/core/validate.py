"""Matching output validation (port of ``repro.core.validate``), paper
§II-B:

  (a) validity   — no two selected edges share an endpoint;
  (b) maximality — every valid edge shares an endpoint with a selected edge.

The checks run as tensor code on the mask's device; the first-offender
diagnosis runs on the host, on the failure path only.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.graphs.types import EdgeList


def check_matching(edges: EdgeList,
                   match_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{"valid", "maximal", "num_matches", "num_covered_vertices"}`` as
    0-d tensors on ``match_mask``'s device."""
    dev = match_mask.device
    e = edges.to(dev).canonical()
    n = e.num_vertices
    if e.num_edges == 0 or n == 0:
        # degenerate inputs: vacuously a valid maximal matching
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        true = torch.tensor(True, device=dev)
        return {"valid": true, "maximal": true, "num_matches": zero,
                "num_covered_vertices": zero}
    # canonical() gives u <= v, so v < n bounds both endpoints: rows past
    # num_vertices are dead, never aliased onto a real vertex
    valid = (e.u != e.v) & (e.u >= 0) & (e.v < n)
    mask = match_mask.bool() & valid
    inc = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    ones = torch.ones_like(e.u)
    inc.index_add_(0, torch.where(mask, e.u, n).long(), ones)
    inc.index_add_(0, torch.where(mask, e.v, n).long(), ones)
    is_valid = (inc[:n] <= 1).all()
    # slot n is always uncovered: dead edges gather it
    covered = torch.cat([inc[:n] > 0,
                         torch.zeros((1,), dtype=torch.bool, device=dev)])
    cov_u = covered[torch.where(valid, e.u, n).long()]
    cov_v = covered[torch.where(valid, e.v, n).long()]
    is_maximal = (~valid | cov_u | cov_v).all()
    return {
        "valid": is_valid,
        "maximal": is_maximal,
        "num_matches": mask.sum(),
        "num_covered_vertices": covered[:n].sum(),
    }


def check_state_domain(state: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Domain check of a final vertex-state array at any width: only ACC(0)
    or MCHD(2) may survive a finished run. Returns ``{"clean",
    "out_of_domain", "rsvd_leaked"}``."""
    ood = ((state != 0) & (state != 1) & (state != 2)).sum(dtype=torch.int32)
    rsvd = (state == 1).sum(dtype=torch.int32)
    return {"clean": (ood == 0) & (rsvd == 0), "out_of_domain": ood,
            "rsvd_leaked": rsvd}


def first_offender(edges: EdgeList, match_mask) -> str:
    """The FIRST stream edge that breaks validity (selected, but an endpoint
    is covered by an earlier selected edge) or, failing that, maximality
    (valid, unmatched, both endpoints uncovered). Host numpy."""
    e = edges.canonical()
    u, v = (a.astype(np.int64) for a in e.to_numpy())
    n = e.num_vertices
    mask = torch.as_tensor(match_mask).cpu()  # host-sync: ok — error path
    mask = np.asarray(mask, bool)
    valid = (u != v) & (u >= 0) & (v < n)
    covered = np.zeros(n, bool)
    for i in np.flatnonzero(mask & valid):
        if covered[u[i]] or covered[v[i]]:
            return (f"first offending edge ({u[i]}, {v[i]}) at stream "
                    f"index {i}: selected but an endpoint is already "
                    "covered by an earlier selected edge")
        covered[u[i]] = covered[v[i]] = True
    free = valid & ~mask & ~covered[np.clip(u, 0, n - 1)] \
        & ~covered[np.clip(v, 0, n - 1)]
    if free.any():
        i = int(np.flatnonzero(free)[0])
        return (f"first offending edge ({u[i]}, {v[i]}) at stream index "
                f"{i}: unmatched with both endpoints uncovered")
    return "no offending edge found (mask/graph disagree with the check?)"


def assert_matching(edges: EdgeList, match_mask: torch.Tensor,
                    label: str = "") -> Dict[str, int]:
    """Raise ``AssertionError`` naming the first offending edge unless the
    mask is a valid maximal matching; returns the check as Python values."""
    check = check_matching(edges, match_mask)
    out = {k: x.item() for k, x in check.items()}  # host-sync: ok — to Python
    if not out["valid"]:
        raise AssertionError(
            f"{label}: matching has endpoint collisions — "
            + first_offender(edges, match_mask))
    if not out["maximal"]:
        raise AssertionError(
            f"{label}: matching is not maximal — "
            + first_offender(edges, match_mask))
    return out
