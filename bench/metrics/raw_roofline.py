"""The raw-stream call's share of the card's roofline, in %
(``match_roofline``'s reading in the raw cells)."""
from bench.metrics.match_roofline import read  # noqa: F401
