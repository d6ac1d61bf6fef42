"""MB (10^6 B) a ``skipper_match`` call moves from host memory to the card:
the program's counter ``h2d_bytes`` over the count of its ``skipper_match``
spans, both kept by its registry over every call of the run."""
from bench.metrics import _spans


def read(record: dict):
    reg = _spans.registry()
    if not record["calls"] or reg is None:
        return None
    calls = reg.spans().get("skipper_match", {}).get("count", 0)
    if not calls:
        return None
    return reg.counters().get("h2d_bytes", 0) / calls / 1e6
