from repro_torch.kernels.skipper_match.ops import (
    skipper_match,
    skipper_match_window,
)
from repro_torch.kernels.skipper_match.ref import (
    make_ref_pipeline,
    ref_boundary_pass,
    ref_match_window,
)

__all__ = [
    "skipper_match",
    "skipper_match_window",
    "make_ref_pipeline",
    "ref_boundary_pass",
    "ref_match_window",
]
