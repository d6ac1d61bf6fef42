"""APRAM interleaving conformance (port of ``repro.testing``; DESIGN.md
§13).

Skipper's headline claim is schedule-independence: the merged
reserve+commit step is safe in the asynchronous PRAM model — ANY
interleaving of per-edge events over the single-byte vertex cells ends in
a valid maximal matching after one pass. The port's matchers execute one
deterministic schedule, so the property the paper is *about* needs its own
ground-truth model:

* :mod:`repro_torch.testing.apram` — a step-level numpy model of the
  protocol where each edge's reserve+commit is one atomic event, with
  per-step invariant checks (state domain, no double-match, monotone
  commit) and quiescence checks (validity + maximality via
  ``core/validate``), plus seeded protocol *mutations* that the harness
  must catch.
* :mod:`repro_torch.testing.scheduler` — the adversarial scheduler zoo:
  seeded-random, round-robin thread interleavings, hub-contention worst
  case, and exhaustive enumeration of every interleaving for tiny
  instances.
* :mod:`repro_torch.testing.oracle` — differential conformance: pin any
  production matching as ONE reachable APRAM trace of the same edge
  stream (the matched-first witness schedule), executed through the
  checked model rather than trusted as a theorem.
* :mod:`repro_torch.testing.fuzz` — the seeded fuzzer and corpus replay,
  run as ``python -m repro_torch.testing.fuzz``.

The model and the schedulers are numpy; the quiescence check and the
entry-point pins use the port's own modules, never the other way around.
"""
from repro_torch.testing.apram import (
    ApramResult,
    ApramViolation,
    MUTATIONS,
    run_schedule,
)
from repro_torch.testing.oracle import (
    ConformanceError,
    bipartite_stream,
    pin_entry_points,
    pin_trace,
    witness_schedule,
)
from repro_torch.testing.scheduler import (
    MAX_EXHAUSTIVE_EVENTS,
    exhaustive_schedules,
    hub_contention,
    random_schedule,
    round_robin,
    stream_order,
    sweep,
)

__all__ = [
    "ApramResult",
    "ApramViolation",
    "MUTATIONS",
    "run_schedule",
    "ConformanceError",
    "bipartite_stream",
    "pin_entry_points",
    "pin_trace",
    "witness_schedule",
    "MAX_EXHAUSTIVE_EVENTS",
    "exhaustive_schedules",
    "hub_contention",
    "random_schedule",
    "round_robin",
    "stream_order",
    "sweep",
]
