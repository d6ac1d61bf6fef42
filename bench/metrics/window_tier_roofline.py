"""The window tier's share of its roofline, in %: the windowed edges'
and the dense windows' least bytes at the memory rate over the window
tier's kernel time a call."""
from bench.metrics._roofline import tier_share

#: the profiler's names of the window tier's kernels (either instance)
KERNELS = ("skipper_window_async_kernel", "skipper_window_tier_kernel")


def read(record: dict):
    return tier_share(record, "window_tier", KERNELS)
