"""The share, in %, of the bytes a ``skipper_match`` call moves to the card
that go through the program's pinned staging and its copy stream: the
program's counter ``h2d_staged_bytes`` over ``h2d_bytes``, both kept by its
registry over every call of the run. Nothing where the program keeps no
such counter (it stages nothing of its own) or moved no byte."""
from bench.metrics import _spans


def read(record: dict):
    reg = _spans.registry()
    if not record["calls"] or reg is None:
        return None
    counts = reg.counters()
    staged, moved = counts.get("h2d_staged_bytes"), counts.get("h2d_bytes")
    if staged is None or not moved:
        return None
    return staged / moved * 100.0
