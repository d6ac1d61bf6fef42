"""Core: state widths, result types, the first-claim engine, validation,
the sequential oracle, the single-pass matcher ``skipper`` and the EMS
baselines it is evaluated against, and the conflict table."""
from repro_torch.core.statespec import StateSpec
from repro_torch.core.types import ACC, RSVD, MCHD, Counters, MatchResult
from repro_torch.core.validate import (
    assert_matching,
    check_matching,
    check_state_domain,
)
from repro_torch.core.sgmm import sgmm
from repro_torch.core.skipper import skipper
from repro_torch.core.ems import ems_idmm, ems_israeli_itai, sidmm
from repro_torch.core.conflicts import conflict_table

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
    "skipper",
    "ems_israeli_itai",
    "ems_idmm",
    "sidmm",
    "conflict_table",
]
