"""The end-to-end metrics, one reader each: ``read(window) -> float or
None``, over the window's record (``harness.window_record``): the calls'
host-clock latencies, the window's length, the edges a call decides, the
window's peak device memory and the set-up time."""
