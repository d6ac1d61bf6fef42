"""Graph substrate: the edge-list and CSR containers, generators, CSR
utilities, stream padding, locality reordering and the two-tier window
schedule (host numpy)."""
from repro_torch.graphs.types import CSRGraph, EdgeList
from repro_torch.graphs.generators import (
    bipartite_graph,
    erdos_renyi_graph,
    grid_graph,
    path_graph,
    ring_graph,
    rmat_graph,
    star_graph,
)
from repro_torch.graphs.csr import dedup_edges, edges_to_csr, symmetrize
from repro_torch.graphs.partition import pad_edges
from repro_torch.graphs.reorder import (
    Reordering,
    intra_window_fraction,
    reorder_vertices,
)
from repro_torch.graphs.windows import WindowSchedule, build_window_schedule

__all__ = [
    "EdgeList",
    "CSRGraph",
    "rmat_graph",
    "erdos_renyi_graph",
    "grid_graph",
    "ring_graph",
    "path_graph",
    "star_graph",
    "bipartite_graph",
    "edges_to_csr",
    "symmetrize",
    "dedup_edges",
    "pad_edges",
    "Reordering",
    "reorder_vertices",
    "intra_window_fraction",
    "WindowSchedule",
    "build_window_schedule",
]
