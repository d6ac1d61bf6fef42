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
"""
from __future__ import annotations

from typing import Optional, Tuple

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
