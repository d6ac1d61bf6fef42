"""The share of the window tier's edges that its exact in-tile fallback
decided (free and blocked in every vector round), in %, over the traced
calls (the program's counters ``skipper_match.window_tier.*``)."""
from bench.metrics._spans import fallback_pct


def read(record: dict):
    return fallback_pct(record, "skipper_match.window_tier")
