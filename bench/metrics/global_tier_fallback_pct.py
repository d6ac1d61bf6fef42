"""The share of the global tier's edges that its exact in-tile fallback
decided, in %, over the traced ``skipper_match`` calls (the program's
counters ``skipper_match.global_tier.*``)."""
from bench.metrics._spans import fallback_pct


def read(record: dict):
    return fallback_pct(record, "skipper_match.global_tier")
