"""Shared types for the matching core (port of ``repro.core.types``).

Vertex states follow the paper (Alg. 1): ACC(0) accessible, RSVD(1)
reserved, MCHD(2) matched. The at-rest state array is uint8.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.statespec import DEFAULT as DEFAULT_STATE_SPEC

STATE_DTYPE = DEFAULT_STATE_SPEC.at_rest_dtype

ACC = 0
RSVD = 1
MCHD = 2


@dataclasses.dataclass(frozen=True)
class Counters:
    """Work instrumentation (paper §VI-C, Fig. 7): memory accesses in the
    paper's sense, each an int32 0-d tensor."""

    edge_reads: torch.Tensor     # topology loads (each endpoint pair = 1)
    state_loads: torch.Tensor    # loads of state[]
    state_stores: torch.Tensor   # stores to state[]
    rounds: torch.Tensor         # passes over (parts of) the graph

    @property
    def total_accesses(self) -> torch.Tensor:
        return self.edge_reads + self.state_loads + self.state_stores

    @staticmethod
    def zeros(device=None) -> "Counters":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return Counters(z, z, z, z)


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Output of a matcher.

    match_mask: bool[|E|] in input edge order — True iff that edge was
        selected.
    state: uint8[|V|] final vertex states (ACC or MCHD).
    counters: work instrumentation.
    """

    match_mask: torch.Tensor
    state: torch.Tensor
    counters: Counters

    @property
    def num_matches(self) -> torch.Tensor:
        return self.match_mask.sum()
