"""The share of the traced window with no kernel, copy or memset on the
card, in %."""
from bench import tracing


def read(record: dict):
    window = tracing.window_us(record)
    if window <= 0 or not record["device"]:
        return None
    return (1.0 - tracing.busy_us(record) / window) * 100.0
