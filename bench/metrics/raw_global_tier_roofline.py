"""The global-tier kernel's share of its roofline on the raw stream, in %:
every valid edge and the whole state at the memory rate over the kernel's
time a call (``global_tier_roofline``'s reading in the raw cells)."""
from bench.metrics.global_tier_roofline import read  # noqa: F401
