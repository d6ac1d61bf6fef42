"""Device µs the global-tier kernel takes a tile on the raw stream: its
kernel time a traced call over the tiles a ``skipper`` call lays out. The
tiles a call are the program's counter ``skipper.tiles`` over the count of
its ``skipper`` spans, both kept by its registry over every call of the run
(the warm call among them), so their ratio is exact. Nothing without calls,
without the kernel's time, or where the program keeps no such counter."""
import re

from bench import tracing
from bench.metrics import _spans
from bench.metrics.global_tier_roofline import KERNELS

PATTERN = re.compile("|".join(map(re.escape, KERNELS)))


def read(record: dict):
    calls = len(record["calls"])
    reg = _spans.registry()
    if not calls or reg is None:
        return None
    us = tracing.kernel_us(record, PATTERN)
    tiles = reg.counters().get("skipper.tiles")
    spans = reg.spans().get("skipper", {}).get("count", 0)
    if us <= 0 or not tiles or not spans:
        return None
    return us / calls / (tiles / spans)
