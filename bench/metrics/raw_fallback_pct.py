"""The share of the raw stream's valid edges that the global-tier kernel's
exact in-tile fallback decided, in %, over the traced ``skipper`` calls
(the program's counters ``skipper.*``)."""
from bench.metrics._spans import fallback_pct


def read(record: dict):
    return fallback_pct(record, "skipper")
