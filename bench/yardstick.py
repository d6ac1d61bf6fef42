"""The frozen yardstick: the card's memory rate and the matching's work.

Copied, not imported, from ``repro_torch/roofline/h100.py``: the program
may change its cost models, the benchmark's yardstick may not. The byte
count is the problem's, not the implementation's: no padding slot, no
conflict output, no staging, no counter width. Any kernel that computes
the same matching reads the same count.

* each edge a tier (or the whole call) decides: 8 bytes of ids in (two
  int32 endpoints) and 1 byte of decision out;
* each vertex whose state the tier covers: 1 byte in and 1 byte out.
"""
from __future__ import annotations

#: H100 SXM device-memory rate, bytes/s (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12

#: bytes each decided edge moves at the least: two int32 ids in, one
#: byte of decision out
EDGE_BYTES = 9
#: bytes each covered vertex moves at the least: one byte of state in and
#: one out
VERTEX_BYTES = 2


def problem_bytes(edges: int, vertices: int) -> int:
    """The least bytes a matching of ``edges`` decisions over a state of
    ``vertices`` cells moves."""
    if edges < 0 or vertices < 0:
        raise ValueError("edges and vertices count work and cannot be < 0")
    return EDGE_BYTES * int(edges) + VERTEX_BYTES * int(vertices)


def least_seconds(edges: int, vertices: int) -> float:
    """The least time the card could take for that work: its bytes at the
    memory rate (the matching does no arithmetic worth a compute bound)."""
    return problem_bytes(edges, vertices) / HBM_BYTES_PER_S
