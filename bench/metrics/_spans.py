"""Per-layer metrics read from the program's own spans
(``repro_torch/tracing.py``): in the trace, where a profiler records them
as ``record_function`` events beside the kernels, and in the program's
registry of spans and counters, which the process keeps whether or not a
profiler records."""
from __future__ import annotations

import bisect
import importlib

from bench import tracing

#: the trace's category of a ``record_function`` span on the host
ANNOTATION = "user_annotation"


def registry():
    """The program's registry (``repro_torch.tracing``), or ``None`` for a
    program that has none."""
    try:
        return importlib.import_module("repro_torch.tracing")
    except ImportError:
        return None


def _covered_us(s: float, t: float, busy: list, starts: list) -> float:
    """How much of ``[s, t]`` the merged, sorted intervals ``busy`` cover."""
    us = 0.0
    for b0, b1 in busy[max(0, bisect.bisect_right(starts, s) - 1):]:
        if b0 >= t:
            break
        us += max(0.0, min(t, b1) - max(s, b0))
    return us


def ms_a_call(record: dict, top: str, name: str,
              less_device_work: bool = False) -> "float | None":
    """Host ms a traced call spends in the spans ``name`` that lie inside
    the calls. With ``less_device_work``, less the time in them while the
    card runs kernels or memsets, all queued before the span: a span that
    waits for the card then holds only its own work. ``None`` without
    calls, or where no call holds the entry point's top span ``top`` (a
    program that does not trace itself); 0 where the calls hold no span
    ``name``."""
    calls = record["calls"]
    if not calls:
        return None

    def inside(e):
        s, t = e["ts"], e["ts"] + e["dur"]
        return any(c0 <= s and t <= c1 for c0, c1 in calls)

    spans = [e for e in record["host"]
             if e["cat"] == ANNOTATION and e["name"] in (top, name)]
    if not any(e["name"] == top and inside(e) for e in spans):
        return None
    mine = [e for e in spans if e["name"] == name and inside(e)]
    us = sum(e["dur"] for e in mine)
    if less_device_work:
        busy = tracing.busy_intervals({"device": [
            e for e in record["device"] if e["cat"] != "gpu_memcpy"]})
        starts = [b0 for b0, _ in busy]
        us -= sum(_covered_us(e["ts"], e["ts"] + e["dur"], busy, starts)
                  for e in mine)
    return us / len(calls) / 1e3


def last_s(record: dict, name: str) -> "float | None":
    """Host seconds of the span ``name`` the last time it ran, from the
    program's registry; 0 where it never ran."""
    reg = registry()
    if not record["calls"] or reg is None:
        return None
    return reg.spans().get(name, {}).get("last_s", 0.0)


def fallback_pct(record: dict, prefix: str) -> "float | None":
    """The share of a tier's edges that its exact fallback decided, in %,
    over the traced calls: the registry's ``<prefix>.fallback_edges`` over
    ``<prefix>.edges``, which the program counts only while a profiler
    records. ``None`` where nothing counted the tier's edges (the counter
    exists from the tier's first traced call on, at 0 edges too); 0 where
    the calls counted no edge there."""
    reg = registry()
    if not record["calls"] or reg is None:
        return None
    counts = reg.counters()
    edges = counts.get(f"{prefix}.edges")
    if edges is None:
        return None
    if not edges:
        return 0.0
    return counts.get(f"{prefix}.fallback_edges", 0) / edges * 100.0
