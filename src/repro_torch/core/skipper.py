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
kernel (``kernels/skipper_match/kernel.tiles_on_card``): a raw stream of
``n`` vertices is one state row of width ``n`` and every tile the
same-block pair (0, 0), whose ids all lie below the row's width, so each
tile reads and writes that one row, in tile order. A long stream takes the
kernel's filtered instance: blocks on every SM drop the lanes whose state
already reads matched, and one block resolves the rest in tile order, with
the same result. On the CPU the plain
version runs (``ref.ref_skipper``: ``engine.tile_pass`` looped over the
tiles, as the reference's scan does). ``device=None`` means the card and
raises without one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import engine
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.core.types import Counters, MatchResult
from repro_torch.core.validate import check_matching
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.graphs.partition import pad_edges
from repro_torch.graphs.types import EdgeList

CONFLICT_METHODS = ("auto", "scatter", "sort", "matrix")

__all__ = ["skipper", "stream_tiles", "CONFLICT_METHODS"]


@tracing.spanned("skipper")
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

    Tracing (``repro_torch/tracing.py``): the call is the span ``skipper``,
    its steps ``skipper.stream_tiles``, ``skipper.global_tier`` (with the
    kernel's id check, ``kernels.id_check``) and ``skipper.gather``; every
    call adds its tiles to the host counter ``skipper.tiles``; while a
    profiler records, the valid edges and those the exact fallback decides
    add to ``skipper.edges`` / ``skipper.fallback_edges``, and the lanes
    the kernel resolves in tile order (the filter's survivors) to
    ``skipper.survivor_lanes``.
    """
    if conflict_method not in CONFLICT_METHODS:
        raise ValueError(f"unknown conflict_method {conflict_method!r}; one "
                         f"of {CONFLICT_METHODS}")
    dev = resolve_device(device, "cuda", "skipper")
    spec = resolve_spec(spec)
    n, m = edges.num_vertices, edges.num_edges
    with tracing.span("skipper.stream_tiles"):
        ut, vt = stream_tiles(edges.to(dev), tile_size, dispersed)
    tracing.count("skipper.tiles", ut.shape[0])
    with tracing.span("skipper.global_tier"):
        if resolve_backend(None, dev) == "cuda":
            from repro_torch.kernels.skipper_match.kernel import tiles_on_card

            row = torch.zeros((n,), dtype=spec.vmem_dtype, device=dev)
            matched, conflicts = tiles_on_card(
                row, ut, vt, vector_rounds, spec,
                counter="skipper.survivor_lanes")
            state = row.to(spec.at_rest_dtype)
            conflicts = conflicts.to(torch.int32)
        else:
            from repro_torch.kernels.skipper_match.ref import ref_skipper

            state = torch.zeros((n,), dtype=spec.at_rest_dtype, device=dev)
            matched, conflicts = ref_skipper(
                state, ut, vt, vector_rounds=vector_rounds,
                conflict_method=conflict_method)

    def i32(x):
        if dev.type == "cuda":
            tracing.count("h2d_bytes", 4)
        return torch.tensor(x, dtype=torch.int32, device=dev)

    with tracing.span("skipper.gather"):
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
        engine.count_fallback("skipper", conflicts, vector_rounds, nvalid)
        nconf = conflicts.sum()
        counters = Counters(
            edge_reads=i32(m),
            state_loads=(2 * nvalid + 2 * nconf).to(torch.int32),
            state_stores=(2 * mask.sum()).to(torch.int32),
            rounds=i32(1),
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

