"""The device memory the window needs at its peak, in GiB:
``torch.cuda.max_memory_allocated()`` after a reset at the window's start,
so it counts what the process holds through the window (the inputs among
it) and every call's working set."""


def read(window: dict):
    peak = window.get("peak_bytes")
    return peak / 2**30 if peak else None
