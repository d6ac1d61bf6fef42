"""One-shot host precompute of the device-resident window schedule.

The paper's locality phase cuts the vertex-id space into windows of ``window``
ids and buckets canonical edges by window so the hot loop only ever touches a
window-sized slice of the state array (on the card, one thread block's
shared memory). This module computes the *whole* schedule once, so the
matcher launches one window-tier kernel over every ``(row, tile)`` and one
global-tier kernel, and never returns to the host mid-graph.

Two refinements over the naive bucketing (DESIGN.md §2 A7, §8):

* **Locality reordering** (``reorder=``): vertices are renumbered by a
  ``graphs/reorder.py`` policy before bucketing, so permuted / power-law
  inputs reach grid-like intra-window fractions. The schedule carries the
  permutation (``perm``/``inv``); the matcher maps results back to original
  ids, so callers never see renumbered vertices.
* **Two-tier schedule** (``coalesce_sparse=``): ``tiles_per_window`` is a
  static max, so skewed graphs used to pay padding for every window. Now
  only *dense* windows (tile occupancy >= ``sparse_occupancy`` of the
  densest window's row) get rows in the 2-D grid; sparse windows are
  coalesced into the global stream next to the cross-window edges and
  resolved by the boundary epilogue against the full state — batched tiles,
  zero per-window padding. ``window_ids`` maps schedule rows back to window
  ids (rows are compacted).

Layout (see DESIGN.md "Window-schedule layout"):

    u_tiles / v_tiles : int32[num_rows, tiles_per_window * tile_size]
        window-LOCAL endpoint ids (renumbered-global id minus
        window_ids[row] * window), -1 padding. Row r, flattened slot
        t * tile_size + l is tile t, lane l of window window_ids[r].
    edge_index        : same shape; original stream index of the edge in that
        slot (-1 for padding). This is the slot -> stream half of the
        round-trip mapping; ``stream_to_slot`` computes the inverse.
    boundary_u/v/index: int32[num_boundary_padded] global-tier edges
        (renumbered GLOBAL ids): cross-window edges plus the edges of
        coalesced sparse windows, grouped by **block pair** — the
        (u-window, v-window) pair of each edge — in lexicographic pair
        order, stream-stable within each pair, with every pair group padded
        to a tile multiple so each tile touches exactly one pair. Resolved
        by the in-device block-pair epilogue (DESIGN.md §10), which streams
        only the pair's two window-sized state blocks per tile.
    boundary_ulocal/vlocal: int32[num_boundary_padded] the same edges in the
        epilogue's OFFSET-LOCAL encoding: u minus its block base (in
        [0, window)); v minus its block base, **plus window when the pair is
        cross-block** (in [0, 2*window)) — so the concatenated two-block
        state of a pair tile behaves as one 2*window-vertex id space and
        same-block pairs degenerate to the first block alone.
    boundary_blk_u/blk_v: int32[num_boundary_tiles] per-TILE state-block ids
        of the pair (read per tile by the global-tier kernel;
        num_boundary_tiles = num_boundary_padded // tile_size).

The dispersed deal (paper §IV-C) is applied *within* each window: lane l of
the window's tile stream walks its own contiguous run of that window's edges
(locality preserved per lane) while the lanes of any one tile sit far apart
in the window's stream (dispersed), keeping intra-tile endpoint sharing — the
JIT-conflict source — Θ(λ²)-rare.

Port of ``repro.graphs.windows``: host numpy as before, every field
array-equal to the reference's schedule for the same edges. The port's
kernels read the same layout (``kernels/skipper_match/csrc``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import tracing
from repro_torch.graphs.types import EdgeList
from repro_torch.graphs.reorder import Reordering, reorder_vertices


@dataclasses.dataclass(frozen=True)
class WindowSchedule:
    """Static-shape device schedule for one graph. All arrays are host numpy;
    the matcher moves them to the device once per call.

    Consumed by the single-device pipeline (``kernels/skipper_match/ops``).
    Windows are disjoint vertex-id ranges, so rows are independent."""

    window: int           # vertex ids per window
    tile_size: int
    num_windows: int      # windows covering the id space (state rows)
    tiles_per_window: int
    num_vertices: int
    num_edges: int        # original stream length (mask/conflicts length)
    u_tiles: np.ndarray   # int32[num_rows, tiles_per_window * tile_size], local ids
    v_tiles: np.ndarray
    edge_index: np.ndarray  # int32, same shape, stream index or -1
    boundary_u: np.ndarray  # int32[num_boundary_padded], global ids,
    boundary_v: np.ndarray  #   block-pair grouped order (see module doc)
    boundary_index: np.ndarray
    # block-pair epilogue operands (same grouped order; see module doc)
    boundary_ulocal: np.ndarray = None  # int32[num_boundary_padded]
    boundary_vlocal: np.ndarray = None  # int32[num_boundary_padded]
    boundary_blk_u: np.ndarray = None   # int32[num_boundary_tiles]
    boundary_blk_v: np.ndarray = None   # int32[num_boundary_tiles]
    # two-tier bookkeeping: schedule row r holds window window_ids[r]
    window_ids: np.ndarray = None  # int32[num_rows], default arange
    # locality reordering (None = identity / not reordered)
    reorder: str = "none"
    perm: Optional[np.ndarray] = None   # int32[n]: original id -> renumbered id
    inv: Optional[np.ndarray] = None    # int32[n]: renumbered id -> original id
    # measured locality/packing stats (set by build_window_schedule)
    num_valid: int = 0     # valid edges in the stream
    num_intra: int = 0     # valid edges with both endpoints in one window
    num_windowed: int = 0  # edges placed in the dense (2-D grid) tier
    # stream_src[k] = flat decision-slot index of stream position k in
    # [windowed slots ++ global-tier slots ++ one always-zero pad slot] —
    # lets the matcher GATHER decisions back to stream order (a device
    # scatter of |E| indices costs ~100x more than the gather on CPU XLA).
    stream_src: Optional[np.ndarray] = None  # int32[num_edges]

    def __post_init__(self):
        if self.window_ids is None:
            object.__setattr__(
                self, "window_ids", np.arange(self.num_rows, dtype=np.int32)
            )

    @property
    def num_rows(self) -> int:
        return int(self.u_tiles.shape[0])

    @property
    def num_boundary_padded(self) -> int:
        return int(self.boundary_u.shape[0])

    @property
    def num_boundary_tiles(self) -> int:
        return self.num_boundary_padded // self.tile_size

    @property
    def num_boundary_pairs(self) -> int:
        """Distinct (u-window, v-window) block pairs in the global tier."""
        if self.boundary_blk_u is None or not self.boundary_blk_u.size:
            return 0
        key = (
            self.boundary_blk_u.astype(np.int64) * self.num_windows
            + self.boundary_blk_v
        )
        return int(np.unique(key).size)

    @property
    def intra_fraction(self) -> float:
        """Fraction of valid edges intra-window after reordering — the
        locality number the benches report."""
        return self.num_intra / max(1, self.num_valid)

    @property
    def windowed_fraction(self) -> float:
        """Fraction of valid edges resolved in the dense window tier
        (<= intra_fraction: sparse windows are coalesced into the global
        tier)."""
        return self.num_windowed / max(1, self.num_valid)

    @property
    def padding_waste(self) -> float:
        """Fraction of scheduled slots (both tiers) that are padding."""
        total = self.num_rows * self.tiles_per_window * self.tile_size
        total += self.num_boundary_padded
        used = self.num_windowed + int((self.boundary_index >= 0).sum())
        return (total - used) / max(1, total)

    def vmem_state_bytes(self, spec=None) -> int:
        """Bytes of the per-tile state working set under ``spec`` (a
        ``core/statespec.StateSpec``; default the package spec): the window
        tier holds one ``window``-cell row, the global tier a two-window
        pair — this returns the LARGER of the two."""
        from repro_torch.core.statespec import resolve as resolve_spec

        spec = resolve_spec(spec)
        blocks = 2 if self.num_boundary_padded > 0 else 1
        return blocks * self.window * spec.vmem_bytes

    def slot_to_stream(self) -> np.ndarray:
        """int32[num_rows, tiles_per_window, tile_size] — stream index of
        each schedule slot (-1 = padding)."""
        return self.edge_index.reshape(
            self.num_rows, self.tiles_per_window, self.tile_size
        )

    def stream_to_slot(self) -> np.ndarray:
        """int32[num_edges, 3] — (row, tile, lane) of each stream position,
        or (-1, -1, -1) for edges not in the windowed tier (global-tier /
        invalid edges)."""
        out = np.full((self.num_edges, 3), -1, np.int32)
        s2s = self.slot_to_stream()
        w, t, l = np.nonzero(s2s >= 0)
        out[s2s[w, t, l]] = np.stack([w, t, l], axis=1).astype(np.int32)
        return out


def _dispersed_within(idx: np.ndarray, tiles: int, tile_size: int) -> np.ndarray:
    """Deal a window's padded stream [tiles * tile_size] so tile t, lane l
    holds stream slot l * tiles + t: each lane walks a contiguous run, lanes
    of one tile are ``tiles`` apart."""
    return idx.reshape(tile_size, tiles).T.reshape(-1)


@tracing.spanned("schedule")
def build_window_schedule(
    edges: EdgeList,
    window: int = 2048,
    tile_size: int = 256,
    dispersed: bool = True,
    reorder: str = "none",
    reordering: Optional[Reordering] = None,
    coalesce_sparse: bool = True,
    sparse_occupancy: float = 0.25,
) -> WindowSchedule:
    """Bucket canonical edges by vertex window and pack the two-tier schedule.

    Pure host/numpy, one pass over the edge list (plus the optional
    reordering pass); every output shape depends only on (graph, window,
    tile_size, reorder policy).

    ``reorder`` names a ``graphs/reorder.py`` policy (or pass a precomputed
    ``reordering``); ``coalesce_sparse`` routes windows whose row occupancy
    would be below ``sparse_occupancy`` (relative to the densest window's
    padded row) into the global tier instead of padding them.

    Tracing (``repro_torch/tracing.py``): the call is the span
    ``schedule``, its phases ``schedule.reorder`` (canonical ids, the
    policy and the relabel), ``.split`` (dense and sparse windows),
    ``.window_rows``, ``.pairs`` (the global tier's block-pair grouping)
    and ``.gather_map`` (``stream_src``).
    """
    with tracing.span("schedule.reorder"):
        n = edges.num_vertices
        u0, v0 = edges.to_numpy()
        u = np.minimum(u0, v0).astype(np.int64)   # canonical: u <= v
        v = np.maximum(u0, v0).astype(np.int64)
        m = int(u.shape[0])
        valid = (u >= 0) & (u != v)

        if reordering is None and reorder != "none":
            reordering = reorder_vertices(edges, reorder, window=window)
        perm = inv = None
        if reordering is not None and reordering.policy != "none":
            perm = reordering.perm
            inv = reordering.inv
            reorder = reordering.policy
            u = np.where(valid, perm[np.where(valid, u, 0)], u)
            v = np.where(valid, perm[np.where(valid, v, 0)], v)
        else:
            reorder = "none"

    with tracing.span("schedule.split"):
        wu = np.where(valid, u // window, 0)
        wv = np.where(valid, v // window, 0)
        intra = valid & (wu == wv)
        num_windows = max(1, -(-n // window))

        counts = np.bincount(wu[intra], minlength=num_windows)
        max_count = int(counts.max()) if m else 0

        # ---- two-tier split: dense windows get grid rows, sparse ones
        # coalesce
        if coalesce_sparse and num_windows > 1 and max_count > 0:
            tiles_max = -(-max_count // tile_size)
            occupancy = counts / (tiles_max * tile_size)
            dense = occupancy >= sparse_occupancy
            dense[np.argmax(counts)] = True  # densest window is always a row
            dense &= counts > 0
            if not dense.any():
                dense = counts > 0
        else:
            dense = (counts > 0 if max_count > 0
                     else np.zeros(num_windows, bool))
            if not dense.any():
                dense = np.ones(num_windows, bool)
                dense[1:] = False
        dense_ids = np.nonzero(dense)[0]
        if dense_ids.size == 0:
            dense_ids = np.array([0], np.int64)
        num_rows = int(dense_ids.size)
        dense_max = int(counts[dense_ids].max()) if m else 0
        tiles_per_window = max(1, -(-dense_max // tile_size)) if m else 1
        slots = tiles_per_window * tile_size

        coalesced = intra & ~dense[wu]          # sparse windows' edges
        windowed = intra & dense[wu]
        # boundary + coalesced, stream order
        global_tier = valid & ~windowed

    with tracing.span("schedule.window_rows"):
        u_tiles = np.full((num_rows, slots), -1, np.int32)
        v_tiles = np.full((num_rows, slots), -1, np.int32)
        edge_index = np.full((num_rows, slots), -1, np.int32)

        # stable bucket: windowed edges of window w in stream order
        order = np.nonzero(windowed)[0]
        win_of = wu[order]
        sort = np.argsort(win_of, kind="stable")
        order = order[sort]
        wcounts = counts * dense                # windowed edges per window
        starts = np.concatenate([[0], np.cumsum(wcounts[dense_ids])])
        for r, w in enumerate(dense_ids):
            sel = order[starts[r] : starts[r + 1]]
            if sel.size == 0:
                continue
            pad = np.full((slots,), -1, np.int64)
            pad[: sel.size] = sel
            if dispersed:
                pad = _dispersed_within(pad, tiles_per_window, tile_size)
            present = pad >= 0
            src = np.where(present, pad, 0)
            base = w * window
            u_tiles[r] = np.where(present, u[src] - base, -1).astype(np.int32)
            v_tiles[r] = np.where(present, v[src] - base, -1).astype(np.int32)
            edge_index[r] = np.where(present, pad, -1).astype(np.int32)

    with tracing.span("schedule.pairs"):
        # ---- global tier: block-pair grouping (DESIGN.md §10) ------------
        # Group the global-tier stream by the (u-window, v-window) pair of
        # each edge — canonical u <= v gives blk_u <= blk_v — in
        # lexicographic pair order, STABLE within a pair (the stream stays a
        # genuine single pass: each edge is decided once, in a deterministic
        # schedule order). Each pair group is padded to a tile multiple so
        # every epilogue tile touches exactly one pair and the kernel streams
        # just two window-sized state blocks per grid step instead of the
        # full flattened state.
        bsel = np.nonzero(global_tier)[0]
        nb = int(bsel.size)
        if nb:
            ub, vb = u[bsel], v[bsel]
            pu, pv = ub // window, vb // window
            pair_key = pu * num_windows + pv
            order_b = np.argsort(pair_key, kind="stable")
            bsel, ub, vb = bsel[order_b], ub[order_b], vb[order_b]
            pu, pv = pu[order_b], pv[order_b]
            # pair run boundaries -> per-pair tile padding
            starts_b = np.concatenate(
                [[0], np.nonzero(np.diff(pair_key[order_b]))[0] + 1, [nb]]
            )
            sizes = np.diff(starts_b)
            padded_sizes = -(-sizes // tile_size) * tile_size
            nb_pad = int(padded_sizes.sum())
            # grouped slot of in-pair position k of pair p: pad_start[p] + k
            pad_starts = np.concatenate([[0], np.cumsum(padded_sizes)])[:-1]
            slot_of = (np.repeat(pad_starts - starts_b[:-1], sizes)
                       + np.arange(nb))
            boundary_u = np.full((nb_pad,), -1, np.int32)
            boundary_v = np.full((nb_pad,), -1, np.int32)
            boundary_index = np.full((nb_pad,), -1, np.int32)
            boundary_ulocal = np.full((nb_pad,), -1, np.int32)
            boundary_vlocal = np.full((nb_pad,), -1, np.int32)
            boundary_u[slot_of] = ub
            boundary_v[slot_of] = vb
            boundary_index[slot_of] = bsel.astype(np.int32)
            cross = pu != pv
            boundary_ulocal[slot_of] = (ub - pu * window).astype(np.int32)
            boundary_vlocal[slot_of] = (
                vb - pv * window + np.where(cross, window, 0)
            ).astype(np.int32)
            # per-tile pair block ids (every tile sits inside one pair group)
            nb_tiles = nb_pad // tile_size
            blk_of_pair_tile = np.repeat(
                np.arange(len(sizes)), padded_sizes // tile_size
            )
            first = starts_b[:-1]
            boundary_blk_u = pu[first][blk_of_pair_tile].astype(np.int32)
            boundary_blk_v = pv[first][blk_of_pair_tile].astype(np.int32)
            assert boundary_blk_u.shape == (nb_tiles,)
        else:
            nb_pad = 0
            boundary_u = boundary_v = boundary_index = np.zeros((0,), np.int32)
            boundary_ulocal = boundary_vlocal = np.zeros((0,), np.int32)
            boundary_blk_u = boundary_blk_v = np.zeros((0,), np.int32)

    with tracing.span("schedule.gather_map"):
        # stream -> decision-slot gather map (see WindowSchedule.stream_src)
        slots_flat = num_rows * slots
        stream_src = np.full((m,), slots_flat + nb_pad, np.int32)
        rr, ss = np.nonzero(edge_index >= 0)
        stream_src[edge_index[rr, ss]] = (rr * slots + ss).astype(np.int32)
        if nb:
            stream_src[bsel] = (slots_flat + slot_of).astype(np.int32)

    return WindowSchedule(
        window=window,
        tile_size=tile_size,
        num_windows=num_windows,
        tiles_per_window=tiles_per_window,
        num_vertices=n,
        num_edges=m,
        u_tiles=u_tiles,
        v_tiles=v_tiles,
        edge_index=edge_index,
        boundary_u=boundary_u,
        boundary_v=boundary_v,
        boundary_index=boundary_index,
        boundary_ulocal=boundary_ulocal,
        boundary_vlocal=boundary_vlocal,
        boundary_blk_u=boundary_blk_u,
        boundary_blk_v=boundary_blk_v,
        window_ids=dense_ids.astype(np.int32),
        reorder=reorder,
        perm=perm,
        inv=inv,
        num_valid=int(valid.sum()),
        num_intra=int(intra.sum()),
        num_windowed=int(windowed.sum()),
        stream_src=stream_src,
    )
