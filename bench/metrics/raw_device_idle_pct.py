"""The share of the traced window with nothing on the card, in %, in the
raw cells (``device_idle_pct``'s reading)."""
from bench.metrics.device_idle_pct import read  # noqa: F401
