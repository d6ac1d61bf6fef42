"""The global tier's share of its roofline, in %: the least bytes of the
edges it decides and of the whole state at the memory rate over its kernel
time a call."""
from bench.metrics._roofline import tier_share

#: the profiler's names of the global tier's kernels (the asynchronous
#: kernel in either instance; the first global tier for wide tiles)
KERNELS = ("skipper_boundary_async_kernel", "skipper_boundary_kernel")


def read(record: dict):
    return tier_share(record, "global_tier", KERNELS)
