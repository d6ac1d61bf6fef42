"""The share of a tier's roofline: the least time of the tier's work
(``yardstick.least_seconds``) over the device time of its kernels a call."""
from __future__ import annotations

import re

from bench import tracing, yardstick


def tier_share(record: dict, tier: str, kernels) -> "float | None":
    work = record["work"].get(tier)
    calls = len(record["calls"])
    # plain substrings: the names hold no one another, and a mangled name
    # (``_Z29skipper_...``) holds them too
    pattern = re.compile("|".join(map(re.escape, kernels)))
    us = tracing.kernel_us(record, pattern)
    if not work or not calls or us <= 0:
        return None
    return yardstick.least_seconds(**work) / (us * 1e-6 / calls) * 100.0
