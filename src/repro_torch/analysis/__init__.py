"""Kernel conformance analyzer for the port's Hopper kernels (port of
``repro.analysis``).

The JAX analyzer read jaxprs and Mosaic facts. A Hopper kernel has other
artifacts, and this package reads those: nvcc's ``-Xptxas=-v`` report,
the PTX, the launch wrappers' shared-memory formulas, and runs of each
kernel against its plain version. The rules prove per commit that

* no entry function keeps per-thread data in local memory (stack frame or
  spills: ``rules/resources.py`` ``local-memory``), fits the card's
  shared memory with an amount independent of V (``smem-budget``), and
  reports its registers and occupancy (``registers``);
* every path from a shared-memory store to a load of the same region, or
  from a load to a store, passes a block-wide barrier
  (``rules/barrier.py`` ``smem-barrier``);
* both matcher tiers walk their tiles in schedule order
  (``rules/order.py`` ``tier-order``) and each entry point launches the
  kernels it should (``rules/census.py`` ``kernel-census``);
* host syncs appear only at documented sites, ``lru_cache`` keys are
  hashable statics, no literal state dtype escapes ``core/statespec``,
  and no internal caller touches the deprecated
  ``DistStats.gathered_ints`` alias (``rules/host_sync.py``,
  ``rules/state_dtype.py``, ``rules/deprecated_alias.py``).

The JAX rules with no Hopper meaning have no counterpart here:
``mosaic-lowering`` and ``tile-geometry`` (Mosaic facts), ``block-race``
(its role is ``tier-order``'s) and ``traced-callback`` (eager PyTorch
traces nothing).

Entry points: ``python -m repro_torch.analysis`` (CLI, JSON report,
mutation canaries), or programmatically::

    from repro_torch.analysis import run_analysis
    report = run_analysis()          # all targets + src/repro_torch
    assert report.clean, report.render()

Source rules run anywhere; kernel and target rules need nvcc and a card,
and raise without them.
"""
from repro_torch.analysis.report import Finding, Report, Severity
from repro_torch.analysis.runner import (
    analyze_mutation,
    analyze_sources,
    analyze_targets,
    run_analysis,
)

__all__ = [
    "Finding",
    "Report",
    "Severity",
    "analyze_mutation",
    "analyze_sources",
    "analyze_targets",
    "run_analysis",
]
