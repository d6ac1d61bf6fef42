"""Plain PyTorch versions of the two skipper_match kernels (port of
``repro.kernels.skipper_match.ref``).

They run on any device, tile by tile through ``core/engine.py``'s
``tile_pass`` / ``tile_pass_pair``, in the kernels' exact tile order, so the
decisions are bit-identical to the CUDA kernels. The CPU path uses them;
``chip_smoke.py`` holds each kernel against them on the card. Nothing on
the main path calls them when a card is present.

* :func:`ref_window_tier` — plain version of ``skipper_window_tier_kernel``:
  every row starts from its ``state_in`` row and runs its tiles in order.
* :func:`ref_match_window` / :func:`make_ref_pipeline` — the reference's
  two names for the one-row and the all-ACC cases of it.
* :func:`ref_boundary_pass` — plain version of ``skipper_boundary_kernel``:
  ``tile_pass_pair`` looped over the global tier in schedule order.
* :func:`ref_boundary_pass_prefetched` — the same result in the tile order
  of ``skipper_boundary_async_kernel``'s device-memory instance: each
  tile's cells read ahead, checked against the commits in between, later
  rounds from the tile's own commits. No path calls it; the tests pin it
  to :func:`ref_boundary_pass` and :func:`ref_skipper`.
* :func:`ref_skipper` — plain version of the raw-stream matcher
  (``core/skipper.py``), which on the card is the global tier over one
  state row with every tile the same-block pair (0, 0): ``tile_pass``
  looped over the tiles on the full state, as the reference's scan does.
* :func:`ref_skipper_filtered` — the same result computed as the global
  tier's filtered instance computes it: a filter against a stale snapshot
  of the state, then the survivors resolved in packs, in tile order. No
  path calls it; the tests pin it to :func:`ref_skipper`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import engine
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec


def ref_window_tier(
    u_rows: torch.Tensor,     # int32[num_rows, tiles_per_row * T]
    v_rows: torch.Tensor,     # window-local ids, -1 padding
    state_in: torch.Tensor,   # [num_rows, W]
    *,
    tile_size: int,
    vector_rounds: int = 1,
    fallback: bool = True,
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(states, matched, conflicts)``: ``states`` a new tensor of
    ``state_in``'s dtype and shape, matched/conflicts ``spec.counter`` of
    ``u_rows``'s shape."""
    spec = resolve_spec(spec)
    cdt = spec.counter_dtype
    num_rows, slots = u_rows.shape
    window = state_in.shape[1]
    states = state_in.clone()
    matched = torch.zeros((num_rows, slots), dtype=cdt, device=u_rows.device)
    conflicts = torch.zeros_like(matched)
    for r in range(num_rows):
        row = states[r]
        for s in range(0, slots, tile_size):
            sl = slice(s, s + tile_size)
            _, mt, cf, _ = engine.tile_pass(
                row, u_rows[r, sl], v_rows[r, sl], n=window,
                vector_rounds=vector_rounds, fallback=fallback, spec=spec,
            )
            matched[r, sl] = mt.to(cdt)
            conflicts[r, sl] = cf
    return states, matched, conflicts


def ref_match_window(
    u_tiles: torch.Tensor,    # int32[num_tiles, T]
    v_tiles: torch.Tensor,
    state0: torch.Tensor,     # [W]
    vector_rounds: int = 1,
    fallback: bool = True,
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One window from a caller-given state. Returns ``(state,
    matched spec.counter[num_tiles*T], conflicts[...])``."""
    num_tiles, t = u_tiles.shape
    states, matched, conflicts = ref_window_tier(
        u_tiles.reshape(1, num_tiles * t), v_tiles.reshape(1, num_tiles * t),
        state0.reshape(1, -1), tile_size=t, vector_rounds=vector_rounds,
        fallback=fallback, spec=spec,
    )
    return states[0], matched.reshape(-1), conflicts.reshape(-1)


def make_ref_pipeline(window: int, vector_rounds: int = 1,
                      spec: Optional[StateSpec] = None):
    """Plain twin of the window tier for a fixed window size: every row
    starts from all-ACC state. The returned callable maps (u3, v3)
    int32[num_rows, tiles_per_window, T] to (states spec.vmem[num_rows,
    window], matched spec.counter[num_rows, tpw*T], conflicts[...])."""
    spec = resolve_spec(spec)

    def run(u3, v3):
        num_rows, tpw, t = u3.shape
        state0 = torch.zeros((num_rows, window), dtype=spec.vmem_dtype,
                             device=u3.device)
        return ref_window_tier(
            u3.reshape(num_rows, tpw * t), v3.reshape(num_rows, tpw * t),
            state0, tile_size=t, vector_rounds=vector_rounds, spec=spec,
        )

    return run


def ref_boundary_pass(
    state_rows: torch.Tensor,   # [num_windows, W], updated in place
    blk_u: torch.Tensor,        # int32[num_tiles]
    blk_v: torch.Tensor,
    u_tiles: torch.Tensor,      # int32[num_tiles, T] offset-local ids
    v_tiles: torch.Tensor,
    *,
    vector_rounds: int = 1,
    fallback: bool = True,
    conflict_method: str = "auto",
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global tier in schedule order: tile k sees every earlier tile's
    commits. Updates ``state_rows`` in place; returns ``(matched,
    conflicts)``, both ``spec.counter[num_tiles, T]``."""
    spec = resolve_spec(spec)
    cdt = spec.counter_dtype
    window = state_rows.shape[1]
    matched = torch.zeros(u_tiles.shape, dtype=cdt, device=u_tiles.device)
    conflicts = torch.zeros_like(matched)
    pairs = zip(blk_u.tolist(), blk_v.tolist())  # host-sync: ok — host loop
    for k, (bu, bv) in enumerate(pairs):
        _, mt, cf, _ = engine.tile_pass_pair(
            state_rows, u_tiles[k], v_tiles[k], bu, bv, window=window,
            vector_rounds=vector_rounds, fallback=fallback,
            conflict_method=conflict_method, spec=spec,
        )
        matched[k] = mt.to(cdt)
        conflicts[k] = cf
    return matched, conflicts


def ref_boundary_pass_prefetched(
    state_rows: torch.Tensor,   # [num_windows, W], contiguous, updated in place
    blk_u: torch.Tensor,        # int32[num_tiles]
    blk_v: torch.Tensor,
    u_tiles: torch.Tensor,      # int32[num_tiles, T] offset-local ids
    v_tiles: torch.Tensor,
    *,
    vector_rounds: int = 1,
    fallback: bool = True,
    spec: Optional[StateSpec] = None,
    race: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, int]]:
    """:func:`ref_boundary_pass`'s result, computed as the device-memory
    instance of ``skipper_boundary_async_kernel`` computes it (the kernel's
    ``prefetched_tile``): a lane's two cells of tile t are read
    ``kernel.PREFETCH_TILES`` tiles ahead, once the tile before those in
    between has committed; a lane read ACC/ACC is free at round 0 unless a
    tile in between committed one of its cells, compared as flat state
    cells; a later round takes only the lanes blocked in the round before,
    each free unless this tile's commits took a cell. ``race``, a
    generator, lets each read still in flight see a commit of its cell with
    probability 1/2, as a load racing the commit may.

    Returns ``(matched, conflicts, stats)``: the first two as
    :func:`ref_boundary_pass`'s, ``stats`` the profile's counts
    ``stale_lanes``, ``later_round_tiles``, ``free_tiles`` and
    ``free_rounds``."""
    from repro_torch.kernels.skipper_match import kernel

    spec = resolve_spec(spec)
    spec.validate_rounds(vector_rounds)
    depth = kernel.PREFETCH_TILES
    window = state_rows.shape[1]
    flat = state_rows.view(-1)
    num_tiles, tile = u_tiles.shape
    dev = u_tiles.device
    matched = torch.zeros(u_tiles.shape, dtype=spec.counter_dtype, device=dev)
    conflicts = torch.zeros_like(matched)
    stats = dict(stale_lanes=0, later_round_tiles=0, free_tiles=0,
                 free_rounds=0)
    bus, bvs = blk_u.tolist(), blk_v.tolist()  # host-sync: ok — host loop

    def lanes(k):
        u, v = u_tiles[k].long(), v_tiles[k].long()
        valid = (u >= 0) & (u != v)

        def cell(ids):
            c = torch.where(ids < window, bus[k] * window + ids,
                            bvs[k] * window + ids - window)
            return torch.where(valid, c, 0)

        return u, v, valid, cell(u), cell(v)

    reads = {}  # tile -> [cell u, cell v, value u, value v], in flight

    def read_ahead(k):
        _, _, _, cu, cv = lanes(k)
        reads[k] = [cu, cv, flat[cu].clone(), flat[cv].clone()]

    commits = {}  # tile -> its committed cells
    for k in range(min(depth, num_tiles)):
        read_ahead(k)
    for t in range(num_tiles):
        if t + depth < num_tiles:
            read_ahead(t + depth)
        _, _, a, b = reads.pop(t)
        u, v, valid, cu, cv = lanes(t)
        cand = valid & (a == engine.ACC) & (b == engine.ACC)
        between = torch.cat([commits[t - d] for d in range(1, depth + 1)
                             if t - d >= 0] + [cu[:0]])
        stale = cand & (torch.isin(cu, between) | torch.isin(cv, between))
        stats["stale_lanes"] += int(stale.sum())  # host-sync: ok — counts
        cand &= ~stale
        blocked_fn = engine.blocked_from_matrix(
            engine.share_matrix(u, v, valid))
        own = cu[:0]
        mt = torch.zeros(tile, dtype=torch.bool, device=dev)
        cf = torch.zeros(tile, dtype=torch.int32, device=dev)
        rounds, r = 0, 0
        while fallback or r < vector_rounds:
            stats["later_round_tiles"] += r == 1
            free = cand & ~(torch.isin(cu, own) | torch.isin(cv, own))
            blocked = blocked_fn(free)
            if r < vector_rounds:
                cf += blocked.to(torch.int32)
            commit = free & ~blocked
            done = torch.cat([cu[commit], cv[commit]])
            flat[done] = engine.MCHD
            own = torch.cat([own, done])
            if race is not None:
                for rd in reads.values():
                    for side in (0, 1):
                        hit = torch.isin(rd[side], done) & (torch.rand(
                            tile, generator=race) < 0.5)
                        rd[2 + side] = torch.where(
                            hit, engine.MCHD, rd[2 + side])
            mt |= commit
            rounds += bool(commit.any())  # host-sync: ok — host loop
            cand = blocked
            if not bool(blocked.any()):  # host-sync: ok — host loop
                break
            r += 1
        commits[t] = own
        commits.pop(t - depth, None)
        stats["free_tiles"] += rounds > 0
        stats["free_rounds"] += rounds
        matched[t] = mt.to(matched.dtype)
        conflicts[t] = cf.to(conflicts.dtype)
    return matched, conflicts, stats


def ref_skipper(
    state: torch.Tensor,        # [n], updated in place
    u_tiles: torch.Tensor,      # int32[num_tiles, T] vertex ids
    v_tiles: torch.Tensor,
    *,
    vector_rounds: int = 1,
    conflict_method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The raw edge stream's tiles in order against the full state: tile k
    sees every earlier tile's commits. Updates ``state`` in place; returns
    ``(matched bool[num_tiles, T], conflicts int32[num_tiles, T])``, the
    widths of the reference's scan."""
    n = state.shape[0]
    matched = torch.zeros(u_tiles.shape, dtype=torch.bool,
                          device=u_tiles.device)
    conflicts = torch.zeros(u_tiles.shape, dtype=torch.int32,
                            device=u_tiles.device)
    for k in range(u_tiles.shape[0]):
        _, matched[k], conflicts[k], _ = engine.tile_pass(
            state, u_tiles[k], v_tiles[k], n=n, vector_rounds=vector_rounds,
            conflict_method=conflict_method,
        )
    return matched, conflicts


def ref_skipper_filtered(
    state: torch.Tensor,        # [n], updated in place
    u_tiles: torch.Tensor,      # int32[num_tiles, T] vertex ids
    v_tiles: torch.Tensor,
    *,
    vector_rounds: int = 1,
    lag: Optional[int] = None,
    pack: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, int]]:
    """:func:`ref_skipper`'s result, computed as the filtered instance of
    ``skipper_boundary_async_kernel`` computes it (``filter_tiles`` and
    ``resolve_in_order`` in the CUDA source), in two phases:

    * the filter: tile t's lanes are read against the state once every
      tile before ``t - lag`` is resolved (``lag=None``: against the state
      as it comes, every tile at once); a valid lane with a cell MCHD is
      final (unmatched, no conflict), the others survive, in lane order;
    * the in-order pass: packs of consecutive filtered tiles, as many as
      fit ``pack`` survivors (``kernel.FILTERED_THREADS`` by default; at
      least one tile). A pack re-reads its survivors' cells; its mask is
      the sequential greedy over its free survivors in (tile, lane) order,
      by first-claim rounds over the pack; an entry is free at its tile's
      round 0 unless a commit of an earlier tile of the pack took a cell,
      and each tile then runs its vector rounds among its own free lanes
      for the conflicts.

    The kernel's lag lies between 0 and ``kernel.FILTERED_LAG - 1`` and
    moves with timing; any lag gives the same result. Returns
    ``(matched bool[num_tiles, T], conflicts int32[...], stats)``, the
    first two as :func:`ref_skipper`'s, ``stats`` the counts
    ``survivor_lanes`` (the lanes passed to the in-order pass), ``packs``
    and ``pack_rounds`` (the pack rounds that committed, summed)."""
    from repro_torch.kernels.skipper_match import kernel

    if pack is None:
        pack = kernel.FILTERED_THREADS
    num_tiles, tile = u_tiles.shape
    if pack < tile:
        raise ValueError(f"a pack of {pack} cannot hold a tile of {tile}")
    dev = state.device
    u, v = u_tiles.long(), v_tiles.long()
    valid = (u >= 0) & (u != v)
    cu, cv = torch.where(valid, u, 0), torch.where(valid, v, 0)
    matched = torch.zeros(u.shape, dtype=torch.bool, device=dev)
    conflicts = torch.zeros(u.shape, dtype=torch.int32, device=dev)
    stats = dict(survivor_lanes=0, packs=0, pack_rounds=0)
    lag = num_tiles if lag is None else lag
    survivors = {}  # tile -> its surviving lanes, in lane order
    done = 0        # tiles resolved
    while done < num_tiles:
        for t in range(len(survivors), min(num_tiles, done + lag + 1)):
            live = (valid[t] & (state[cu[t]] != engine.MCHD)
                    & (state[cv[t]] != engine.MCHD))
            survivors[t] = live.nonzero().flatten()
        tiles, total = [done], len(survivors[done])
        while (tiles[-1] + 1 < len(survivors)
               and total + len(survivors[tiles[-1] + 1]) <= pack):
            tiles.append(tiles[-1] + 1)
            total += len(survivors[tiles[-1]])
        stats["packs"] += 1
        stats["survivor_lanes"] += total
        done = tiles[-1] + 1
        if total == 0:
            continue
        counts = torch.tensor([len(survivors[t]) for t in tiles], device=dev)
        et = torch.repeat_interleave(torch.arange(len(tiles), device=dev), counts)
        base = torch.cumsum(counts, 0) - counts  # each tile's first entry
        b0, b1 = base[et], (base + counts)[et]
        rows = torch.tensor(tiles, device=dev)[et]
        lanes = torch.cat([survivors[t] for t in tiles])
        eu, ev = cu[rows, lanes], cv[rows, lanes]
        idx = torch.arange(total, device=dev)
        fr = (state[eu] == engine.ACC) & (state[ev] == engine.ACC)
        # the cell table: compact cell ids
        uniq, cells = torch.unique(torch.cat([eu, ev]), return_inverse=True)
        su, sv, ncell = cells[:total], cells[total:], uniq.shape[0]

        def claims(active, a, b, slots):
            cand = torch.where(active, idx, total)
            best = torch.full((slots,), total, device=dev)
            best = best.scatter_reduce(0, a, cand, "amin")
            return best.scatter_reduce(0, b, cand, "amin")

        # the pack's mask: first-claim rounds over its free entries
        active, won = fr.clone(), torch.zeros_like(fr)
        taken = torch.zeros(ncell, dtype=torch.bool, device=dev)
        owner = torch.full((ncell,), -1, device=dev)
        while True:
            active &= ~taken[su] & ~taken[sv]
            if not bool(active.any()):  # host-sync: ok — host loop
                break
            best = claims(active, su, sv, ncell)
            win = active & (best[su] == idx) & (best[sv] == idx)
            for side in (su, sv):
                taken[side[win]] = True
                owner[side[win]] = idx[win]
            won |= win
            active &= ~win
            stats["pack_rounds"] += 1
        # the conflicts: each tile's vector rounds among its own free lanes
        ou, ov = owner[su], owner[sv]
        free = fr & ~((ou >= 0) & (ou < b0)) & ~((ov >= 0) & (ov < b0))
        uniq, pairs = torch.unique(
            torch.cat([et * ncell + su, et * ncell + sv]), return_inverse=True)
        pu, pv, npair = pairs[:total], pairs[total:], uniq.shape[0]
        commit_round = torch.full((total,), vector_rounds, device=dev)
        conf = torch.zeros(total, dtype=torch.int32, device=dev)
        for r in range(vector_rounds):
            best = claims(free, pu, pv, npair)
            blocked = free & ((best[pu] != idx) | (best[pv] != idx))
            conf += blocked.to(torch.int32)
            commit_round[free & ~blocked] = r
            if not bool(blocked.any()):  # host-sync: ok — host loop
                break

            def took(o):  # a commit of this tile by round r took the cell
                return ((o >= b0) & (o < b1)
                        & (commit_round[o.clamp(min=0)] <= r))

            free = blocked & ~took(ou) & ~took(ov)
        state[eu[won]] = engine.MCHD
        state[ev[won]] = engine.MCHD
        matched[rows, lanes] = won
        conflicts[rows, lanes] = conf
    return matched, conflicts, stats
