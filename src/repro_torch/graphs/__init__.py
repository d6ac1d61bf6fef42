"""Graph substrate: the edge-list container, generators, locality
reordering and the two-tier window schedule (host numpy)."""
from repro_torch.graphs.types import EdgeList
from repro_torch.graphs.generators import (
    erdos_renyi_graph,
    grid_graph,
    path_graph,
    ring_graph,
    rmat_graph,
    star_graph,
)
from repro_torch.graphs.reorder import (
    Reordering,
    intra_window_fraction,
    reorder_vertices,
)
from repro_torch.graphs.windows import WindowSchedule, build_window_schedule

__all__ = [
    "EdgeList",
    "rmat_graph",
    "erdos_renyi_graph",
    "grid_graph",
    "ring_graph",
    "path_graph",
    "star_graph",
    "Reordering",
    "reorder_vertices",
    "intra_window_fraction",
    "WindowSchedule",
    "build_window_schedule",
]
