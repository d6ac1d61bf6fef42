"""What the end-to-end readers share: the rate and the tail of a closed
loop's window."""
import math


def medges_s(window: dict):
    """Millions of edges a second: the edges of every call completed in the
    window over the window's wall time."""
    done = window["calls"] - window["failed"]
    if done <= 0 or window["window_s"] <= 0:
        return None
    return done * window["edges_per_call"] / window["window_s"] / 1e6


def percentile(values, q: float) -> float:
    """Nearest rank: the smallest value that at least ``q`` of the values
    do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def p95_ms(window: dict):
    """The 95th percentile of every call's wall time in the window, from
    issue to the synchronize that ends it, in ms."""
    if not window["latencies_s"]:
        return None
    return percentile(window["latencies_s"], 0.95) * 1e3
