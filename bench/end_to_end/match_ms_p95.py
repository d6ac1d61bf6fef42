"""``skipper_match``'s tail: the 95th percentile of a call's wall time, in
ms (``_window.p95_ms``)."""
from bench.end_to_end._window import p95_ms as read  # noqa: F401
