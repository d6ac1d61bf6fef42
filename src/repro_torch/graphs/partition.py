"""Thread-dispersed and locality-sharded edge scheduling, paper §IV-C (port
of ``repro.graphs.partition``).

The paper deals the edge stream's blocks to threads round-robin: thread t
gets blocks t, t+T, t+2T, ..., so each thread scans consecutive edges
(locality) while concurrently active blocks lie far apart in vertex ids
(dispersion), which makes JIT conflicts rare. Here the threads are the
ranks of the distributed matcher (``core/distributed.py``):
``dispersed_blocks`` lays the padded stream out as [D, rounds, block] so
that round r of rank d is block ``r * D + d``.

``partition_schedule`` is the *locality-sharded* deal: it splits a
two-tier ``WindowSchedule`` across ranks. Windows are disjoint vertex-id
ranges, so each rank resolves its dealt window rows alone; only the
global tier goes through the propose/gather/replay protocol, dealt
round-robin like ``dispersed_blocks``. The schedule's ``perm`` and
``stream_src`` ride along, so results come back in original stream order
and vertex ids.

Host numpy, as in the reference, except ``pad_edges``,
``dispersed_blocks`` and ``contiguous_chunks``, which keep the edges'
tensors on their device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.types import INVALID, EdgeList
from repro_torch.graphs.windows import WindowSchedule, build_window_schedule


def pad_edges(edges: EdgeList, multiple: int) -> EdgeList:
    """Pad the edge arrays to a multiple of ``multiple`` with inert
    ``(INVALID, INVALID)`` self-loop sentinels, on the edges' device."""
    m = edges.num_edges
    pad = (-m) % multiple
    if pad == 0:
        return edges
    fill = torch.full((pad,), int(INVALID), dtype=torch.int32,
                      device=edges.u.device)
    return EdgeList(torch.cat([edges.u, fill]), torch.cat([edges.v, fill]),
                    edges.num_vertices)


def dispersed_blocks(
    edges: EdgeList,
    num_devices: int,
    block_size: int,
    reorder: str = "none",
    window: Optional[int] = None,
    tile_size: int = 256,
):
    """Deal edge blocks round-robin to ranks.

    Returns ``(u_blocks, v_blocks)``, int32 [num_devices, num_rounds,
    block_size] on the edges' device: rank d holds blocks d, d+D, d+2D, ...
    (round r of rank d is block ``r * D + d``).

    ``reorder=`` (a ``graphs/reorder.py`` policy) and/or ``window=``
    switch to the locality-sharded mode and return a
    :class:`DeviceSchedule` instead (see :func:`partition_schedule`).
    """
    if reorder != "none" or window is not None:
        return locality_device_schedule(
            edges, num_devices, block_size,
            window=window, tile_size=tile_size, reorder=reorder,
        )
    padded = pad_edges(edges, num_devices * block_size)
    num_rounds = padded.num_edges // (block_size * num_devices)
    shape = (num_rounds, num_devices, block_size)
    return (padded.u.reshape(shape).transpose(0, 1).contiguous(),
            padded.v.reshape(shape).transpose(0, 1).contiguous())


def locality_device_schedule(
    edges: EdgeList,
    num_devices: int,
    block_size: int,
    *,
    window: Optional[int] = None,
    tile_size: int = 256,
    reorder: str = "none",
    schedule: Optional[WindowSchedule] = None,
) -> "DeviceSchedule":
    """Build (or take) a two-tier window schedule and partition it across
    ranks. ``window=None`` defers to ``build_window_schedule``'s default."""
    if schedule is None:
        kwargs = {} if window is None else {"window": window}
        schedule = build_window_schedule(
            edges, tile_size=tile_size, reorder=reorder, **kwargs
        )
    return partition_schedule(schedule, num_devices, block_size)


@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    """Locality-sharded deal of a :class:`WindowSchedule` across ranks.

    The window tier: schedule rows (dense windows) are dealt whole with an
    LPT greedy (descending edge count to the least-loaded rank, ties to the
    lowest), padded to ``rows_per_device`` with empty (-1) rows. A row's
    result does not depend on which rank ran it.

    The global tier: the schedule's boundary stream (renumbered global ids,
    stream order) dealt round-robin into [D, rounds, block] blocks as
    ``dispersed_blocks`` does; at D = 1 it is the stream in order, which
    keeps a one-rank run bit-identical to ``skipper_match`` on the same
    schedule.

    All arrays are host numpy."""

    schedule: WindowSchedule
    num_devices: int
    block_size: int
    u_rows: np.ndarray     # int32[D, rows_per_device, tpw * tile], local ids
    v_rows: np.ndarray
    row_slot: np.ndarray   # int32[D, rows_per_device] schedule-row idx, -1 pad
    boundary_ub: np.ndarray  # int32[D, R, B] global-tier deal, global ids
    boundary_vb: np.ndarray
    boundary_ib: np.ndarray  # int32[D, R, B] boundary stream position, -1 pad

    @property
    def rows_per_device(self) -> int:
        return int(self.u_rows.shape[1])

    @property
    def num_rounds(self) -> int:
        return int(self.boundary_ub.shape[1])

    @property
    def intra_fraction(self) -> float:
        return self.schedule.intra_fraction

    @property
    def windowed_fraction(self) -> float:
        return self.schedule.windowed_fraction

    @property
    def window_balance(self) -> float:
        """max/mean windowed edges per rank (1.0 = perfectly balanced)."""
        per_dev = np.count_nonzero(self.u_rows >= 0, axis=(1, 2))
        mean = per_dev.mean()
        return float(per_dev.max() / mean) if mean else 1.0


def partition_schedule(
    schedule: WindowSchedule, num_devices: int, block_size: int
) -> DeviceSchedule:
    """Deal a two-tier window schedule to ranks (see :class:`DeviceSchedule`).

    ``block_size`` must be a multiple of the schedule's ``tile_size``, so
    every rank's global-tier slab tiles line up with the global tier's
    tiles (what makes D = 1 bit-identical to ``skipper_match``).
    """
    if block_size % schedule.tile_size != 0:
        raise ValueError(
            f"block_size {block_size} must be a multiple of tile_size "
            f"{schedule.tile_size} (slab tiles must align with the boundary "
            "epilogue's)"
        )
    d = int(num_devices)
    slots = schedule.tiles_per_window * schedule.tile_size

    # --- window tier: LPT deal of rows by valid-edge count ---------------
    counts = np.count_nonzero(schedule.edge_index >= 0, axis=1)
    order = np.argsort(-counts, kind="stable")
    loads = np.zeros(d, np.int64)
    rows_of = [[] for _ in range(d)]
    for r in order:
        dev = int(np.argmin(loads))  # ties -> lowest rank
        rows_of[dev].append(int(r))
        loads[dev] += int(counts[r])
    rows_per_device = max(1, max(len(rs) for rs in rows_of))
    u_rows = np.full((d, rows_per_device, slots), -1, np.int32)
    v_rows = np.full((d, rows_per_device, slots), -1, np.int32)
    row_slot = np.full((d, rows_per_device), -1, np.int32)
    for dev, rs in enumerate(rows_of):
        rs = sorted(rs)  # ascending schedule-row order within a rank
        if rs:
            row_slot[dev, : len(rs)] = rs
            u_rows[dev, : len(rs)] = schedule.u_tiles[rs]
            v_rows[dev, : len(rs)] = schedule.v_tiles[rs]

    # --- global tier: round-robin block deal of the boundary stream ------
    nb_pad = schedule.num_boundary_padded
    per_round = d * block_size
    total_b = -(-max(nb_pad, 1) // per_round) * per_round if nb_pad else 0
    bu = np.full((total_b,), -1, np.int32)
    bv = np.full((total_b,), -1, np.int32)
    bi = np.full((total_b,), -1, np.int32)
    if nb_pad:
        bu[:nb_pad] = schedule.boundary_u
        bv[:nb_pad] = schedule.boundary_v
        real = schedule.boundary_index >= 0
        bi[:nb_pad] = np.where(real, np.arange(nb_pad, dtype=np.int32), -1)
    num_rounds = total_b // per_round if nb_pad else 0
    shape = (num_rounds, d, block_size)
    return DeviceSchedule(
        schedule=schedule,
        num_devices=d,
        block_size=block_size,
        u_rows=u_rows,
        v_rows=v_rows,
        row_slot=row_slot,
        boundary_ub=np.swapaxes(bu.reshape(shape), 0, 1),
        boundary_vb=np.swapaxes(bv.reshape(shape), 0, 1),
        boundary_ib=np.swapaxes(bi.reshape(shape), 0, 1),
    )


def contiguous_chunks(
    edges: EdgeList, num_chunks: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split into equal contiguous chunks (the *non*-dispersed baseline that
    shows the schedule matters): int32 [num_chunks, ceil(m / num_chunks)]
    on the edges' device, padded with INVALID."""
    padded = pad_edges(edges, num_chunks)
    per = padded.num_edges // num_chunks
    return (padded.u.reshape(num_chunks, per),
            padded.v.reshape(num_chunks, per))
