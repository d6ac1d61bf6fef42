"""Core: state widths, result types, the first-claim engine, validation and
the sequential oracle."""
from repro_torch.core.statespec import StateSpec
from repro_torch.core.types import ACC, RSVD, MCHD, Counters, MatchResult
from repro_torch.core.validate import (
    assert_matching,
    check_matching,
    check_state_domain,
)
from repro_torch.core.sgmm import sgmm

__all__ = [
    "StateSpec",
    "ACC",
    "RSVD",
    "MCHD",
    "Counters",
    "MatchResult",
    "assert_matching",
    "check_matching",
    "check_state_domain",
    "sgmm",
]
