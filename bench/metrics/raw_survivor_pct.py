"""The share of the raw stream's valid edges that the global tier's filter
passed on to its in-order pass, in %, over the traced ``skipper`` calls:
the program's counter ``skipper.survivor_lanes`` over ``skipper.edges``,
both counted only while a profiler records. Nothing where the program keeps
no such counter (a global tier without the filter), or without calls."""
from bench.metrics import _spans


def read(record: dict):
    reg = _spans.registry()
    if not record["calls"] or reg is None:
        return None
    counts = reg.counters()
    lanes, edges = counts.get("skipper.survivor_lanes"), counts.get(
        "skipper.edges")
    if lanes is None or not edges:
        return None
    return lanes / edges * 100.0
