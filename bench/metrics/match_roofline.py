"""The whole matching's share of the card's roofline, in %: the least time
of the call's work (every edge's ids in and decision out, every vertex's
state in and out) at the memory rate over the traced calls' mean extent on
the card, from a call's first device operation to its last
(``tracing.call_extents_us``). A kernel taken off the path leaves its own
roofline silent; this one still bounds the call."""
from bench import tracing, yardstick


def read(record: dict):
    work = record["work"].get("call")
    extents = tracing.call_extents_us(record)
    if not work or not extents:
        return None
    mean_us = sum(extents) / len(extents)
    if mean_us <= 0:
        return None
    return yardstick.least_seconds(**work) / (mean_us * 1e-6) * 100.0
