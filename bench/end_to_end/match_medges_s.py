"""``skipper_match``'s rate: millions of edges a second over the window
(``_window.medges_s``)."""
from bench.end_to_end._window import medges_s as read  # noqa: F401
