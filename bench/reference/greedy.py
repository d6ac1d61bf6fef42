"""A plain maximal matcher: the greedy matching of the stream in index
order, computed in rounds.

In each round every live edge (valid, both endpoints free) that has the
least index among the live edges at both its endpoints joins the matching,
and the edges that now touch a matched vertex die. An edge joins exactly
when every earlier edge at its endpoints has died, so the rounds give the
sequential greedy matching in index order (Blelloch, Fineman and Shun,
SPAA 2012), in some tens of rounds on a random stream.

It is not the check: the check accepts any maximal matching. It stands in
the program's place for the control: run to the end its answer passes the
check, and cut short (``max_rounds``) it leaves live edges undecided, which
breaks maximality. Plain PyTorch; it imports nothing of the program.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from bench.reference.maximal_matching import ACC, MCHD


def greedy(u: torch.Tensor, v: torch.Tensor, n: int,
           max_rounds: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(mask bool[m], state uint8[n], rounds)``: the index-order greedy
    matching, or what ``max_rounds`` rounds of it decide."""
    dev = u.device
    m = int(u.shape[0])
    valid = (u != v) & (u >= 0) & (v >= 0) & (u < n) & (v < n)
    uu = torch.where(valid, u, 0).long()
    vv = torch.where(valid, v, 0).long()
    index = torch.arange(m, device=dev)
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    mask = torch.zeros(m, dtype=torch.bool, device=dev)
    live = valid.clone()
    rounds = 0
    while bool(live.any()) and (max_rounds is None or rounds < max_rounds):
        key = torch.where(live, index, m)
        least = torch.full((n,), m, dtype=torch.int64, device=dev)
        least.scatter_reduce_(0, uu, key, "amin")
        least.scatter_reduce_(0, vv, key, "amin")
        join = live & (least[uu] == index) & (least[vv] == index)
        mask |= join
        matched[uu[join]] = True
        matched[vv[join]] = True
        live &= ~matched[uu] & ~matched[vv]
        rounds += 1
    state = torch.where(matched, MCHD, ACC).to(torch.uint8)
    return mask, state, rounds
