"""Skipper: single-pass maximal matching over the raw edge stream (port of
``repro.core.skipper``).

The stream is canonicalised (``u <= v``), padded to whole tiles of
``tile_size`` edges with ``(-1, -1)`` sentinels and laid out as tiles.
Each tile is one first-claim decision step against the full vertex state
(``core/engine.py``): vector rounds, then the exact fallback, so a tile's
result is the sequential index-order greedy over its lanes given every
earlier tile's commits. Every edge is decided the moment its tile is
touched: one pass, and a state of one byte per vertex.

Scheduling (``dispersed=True``): the paper's thread-dispersed,
locality-preserving schedule (§IV-C) maps onto the lanes — lane ``l`` of
tile ``t`` is stream index ``l * num_tiles + t``, so each lane walks its
own contiguous block of the stream while the lanes of one tile sit in
blocks far apart, which makes in-tile endpoint sharing (the JIT conflict)
rare. ``dispersed=False`` takes consecutive edges into a tile, the layout
the paper argues against.

Where it runs: on a CUDA device the tiles go through the global-tier
kernel (``kernels/skipper_match/kernel.boundary_tier``): a raw stream of
``n`` vertices is one state row of width ``n`` and every tile the
same-block pair (0, 0), whose ids all lie below the row's width, so each
tile reads and writes that one row, in tile order. On the CPU the plain
version runs (``ref.ref_skipper``: ``engine.tile_pass`` looped over the
tiles, as the reference's scan does). ``device=None`` means the card and
raises without one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.core.types import Counters, MatchResult
from repro_torch.core.validate import check_matching
from repro_torch.device import resolve_device
from repro_torch.graphs.partition import pad_edges
from repro_torch.graphs.types import EdgeList

CONFLICT_METHODS = ("auto", "scatter", "sort", "matrix")

__all__ = ["skipper", "stream_tiles", "tiles_on_card", "CONFLICT_METHODS"]


def skipper(
    edges: EdgeList,
    tile_size: int = 512,
    vector_rounds: int = 1,
    with_conflicts: bool = False,
    dispersed: bool = True,
    conflict_method: str = "auto",
    verify: bool = False,
    spec: Optional[StateSpec] = None,
    device=None,
) -> Tuple[MatchResult, Optional[torch.Tensor]]:
    """Single-pass tiled Skipper on ``device`` (``None``: the card).
    Returns ``(MatchResult, conflicts_per_edge or None)``.

    ``conflicts_per_edge`` (int32[|E|], the rounds each edge spent blocked:
    the Table II instrumentation) comes with ``with_conflicts``. ``spec``
    sets the state widths: the kernel's state row is ``spec.vmem`` and its
    per-edge outputs ``spec.counter``; the returned state is
    ``spec.at_rest``. ``conflict_method`` picks the plain version's
    blocked predicate on the CPU and never changes the output; the kernel
    has one blocked test of its own and ignores it.

    ``verify=True`` runs ``check_matching`` on the result and raises
    ``RuntimeError`` unless it is a valid maximal matching (this waits for
    the card).
    """
    if conflict_method not in CONFLICT_METHODS:
        raise ValueError(f"unknown conflict_method {conflict_method!r}; one "
                         f"of {CONFLICT_METHODS}")
    dev = resolve_device(device, "cuda", "skipper")
    spec = resolve_spec(spec)
    n, m = edges.num_vertices, edges.num_edges
    ut, vt = stream_tiles(edges.to(dev), tile_size, dispersed)
    if dev.type == "cuda":
        state, matched, conflicts = tiles_on_card(ut, vt, n, vector_rounds,
                                                  spec)
    else:
        from repro_torch.kernels.skipper_match.ref import ref_skipper

        state = torch.zeros((n,), dtype=spec.at_rest_dtype, device=dev)
        matched, conflicts = ref_skipper(
            state, ut, vt, vector_rounds=vector_rounds,
            conflict_method=conflict_method)

    if dispersed:
        # matched[t, l] is stream index l * num_tiles + t
        mask = matched.T.reshape(-1)[:m]
        conflicts = conflicts.T.reshape(-1)[:m]
    else:
        mask = matched.reshape(-1)[:m]
        conflicts = conflicts.reshape(-1)[:m]
    # the reference sums these per tile in int32; a sum taken wide and
    # narrowed once wraps to the same value
    nvalid = (ut >= 0).sum()
    nconf = conflicts.sum()
    counters = Counters(
        edge_reads=torch.tensor(m, dtype=torch.int32, device=dev),
        state_loads=(2 * nvalid + 2 * nconf).to(torch.int32),
        state_stores=(2 * mask.sum()).to(torch.int32),
        rounds=torch.tensor(1, dtype=torch.int32, device=dev),
    )
    result = MatchResult(match_mask=mask, state=state, counters=counters)
    if verify:
        chk = check_matching(edges, mask)
        # the verify path is a host check by definition
        ok_v = bool(chk["valid"])  # host-sync: ok — verify=True
        ok_m = bool(chk["maximal"])  # host-sync: ok — verify=True
        if not (ok_v and ok_m):
            raise RuntimeError(
                f"skipper verify=True: matching failed validation "
                f"(valid={ok_v}, maximal={ok_m})")
    return result, (conflicts if with_conflicts else None)


def stream_tiles(edges: EdgeList, tile_size: int,
                 dispersed: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw stream as tiles, on the edges' device: ``(u_tiles,
    v_tiles)`` int32[num_tiles, tile_size], canonical (``u <= v``), padded
    to whole tiles, contiguous, and with every invalid slot (a self-loop,
    a negative id, the padding) as ``(-1, -1)``, which every matcher skips
    as it skips any invalid slot, and which the kernel's id check admits.
    ``dispersed``: lane ``l`` of tile ``t`` is stream index
    ``l * num_tiles + t``; otherwise ``t * tile_size + l``."""
    e = pad_edges(edges.canonical(), tile_size)
    num_tiles = e.num_edges // tile_size
    if dispersed:
        # lane l <- contiguous block l of the stream; tile t = column t
        ut = e.u.reshape(tile_size, num_tiles).T
        vt = e.v.reshape(tile_size, num_tiles).T
    else:
        ut = e.u.reshape(num_tiles, tile_size)
        vt = e.v.reshape(num_tiles, tile_size)
    valid = (ut != vt) & (ut >= 0)
    pad = torch.full_like(ut, -1)
    return (torch.where(valid, ut, pad).contiguous(),
            torch.where(valid, vt, pad).contiguous())


def tiles_on_card(ut: torch.Tensor, vt: torch.Tensor, n: int,
                  vector_rounds: int = 1, spec: Optional[StateSpec] = None,
                  instance: Optional[str] = None):
    """:func:`stream_tiles`' tiles (CUDA tensors) through the global-tier
    kernel: one fresh state row of width ``n``, every tile the pair (0, 0).
    ``instance`` names the kernel's instance (``"staged"`` or
    ``"device"``); ``None`` lets ``kernel.boundary_instance`` pick it for
    ``n``, as :func:`skipper` does. Returns ``(state spec.at_rest[n],
    matched bool, conflicts int32)``, the last two of ``ut``'s shape."""
    from repro_torch.kernels.skipper_match import kernel

    spec = resolve_spec(spec)
    num_tiles = ut.shape[0]
    row = torch.zeros((1, n), dtype=spec.vmem_dtype, device=ut.device)
    if num_tiles == 0 or n == 0:  # nothing can match: no launch
        spec.validate_rounds(vector_rounds)
        zero = torch.zeros(ut.shape, dtype=torch.int32, device=ut.device)
        return row[0].to(spec.at_rest_dtype), zero > 0, zero
    pairs = torch.zeros((num_tiles,), dtype=torch.int32, device=ut.device)
    matched, conflicts = kernel.boundary_tier(
        row, pairs, pairs, ut, vt, vector_rounds=vector_rounds, spec=spec,
        instance=instance)
    return (row[0].to(spec.at_rest_dtype), matched > 0,
            conflicts.to(torch.int32))
