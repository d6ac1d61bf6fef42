"""Graph substrate: the edge-list and CSR containers, generators, CSR
utilities, locality reordering, the two-tier window schedule (host numpy)
and the distributed matcher's deals (stream padding, dispersed blocks,
the locality-sharded partition)."""
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
from repro_torch.graphs.partition import (
    DeviceSchedule,
    contiguous_chunks,
    dispersed_blocks,
    locality_device_schedule,
    pad_edges,
    partition_schedule,
)
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
    "dispersed_blocks",
    "contiguous_chunks",
    "DeviceSchedule",
    "locality_device_schedule",
    "partition_schedule",
    "Reordering",
    "reorder_vertices",
    "intra_window_fraction",
    "WindowSchedule",
    "build_window_schedule",
]
