"""Capacity-constrained bipartite b-matching over a score-sorted candidate
stream (port of ``repro.core.bipartite``): the Skipper technique as the MoE
router's token-expert assignment.

Tokens x experts, candidate edges (t, e); each token takes at most
``token_budget`` experts, each expert at most ``expert_capacity`` tokens.
``bmatch_assign`` is a thin adapter over the capacitated engine
(``engine.tile_pass_capacitated``): the stream is cut into tiles, and a
loop over them carries the per-side used counts. Its output is exactly the
sequential greedy over the stream: edge i is accepted iff, at its
position, its token has budget left and its expert capacity left.

The reference's ``lax.scan`` over tiles is a Python loop here; each tile's
exact fallback reads its loop condition on the host, so a call syncs with
the device once or more per tile.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import engine
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec

#: Default unrolled rounds per tile (the reference's, and its reason: the
#: score-sorted MoE stream is contended, so round-2 work is common). Not a
#: correctness knob: the exact fallback reaches the same fixpoint from any
#: unroll depth.
BMATCH_VECTOR_ROUNDS = 2


def bmatch_assign(
    token_ids: torch.Tensor,
    expert_ids: torch.Tensor,
    *,
    num_tokens: int,
    num_experts: int,
    token_budget: int,
    expert_capacity: int,
    tile_size: int = 1024,
    vector_rounds: int = BMATCH_VECTOR_ROUNDS,
    conflict_method: str = "auto",
    with_stats: bool = False,
    spec: Optional[StateSpec] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Greedy maximal b-matching over a (pre-sorted) candidate edge stream,
    on the tensors' device.

    token_ids/expert_ids: int32[M] candidate edges, highest score first;
    invalid candidates have ``token_id = -1``. Returns the bool[M] accept
    mask. The stream is padded to whole tiles with ``token_id = -1``.

    ``with_stats=True`` also returns ``{"conflicts", "fallback_tiles"}``,
    int32 scalars: the total blocked-round count and the number of tiles
    that entered the exact fallback.

    ``spec`` sets the used-count width: the spec's at-rest dtype when both
    budgets fit it (``validate_capacity``), int32 otherwise.
    """
    spec = resolve_spec(spec)
    fits = spec.validate_capacity(max(token_budget, expert_capacity))
    used_dt = spec.at_rest_dtype if fits else spec.accum_dtype
    dev = token_ids.device
    m = token_ids.shape[0]
    pad = (-m) % tile_size
    tok = torch.cat([token_ids.to(torch.int32),
                     torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    exp = torch.cat([expert_ids.to(torch.int32),
                     torch.zeros((pad,), dtype=torch.int32, device=dev)])
    num_tiles = tok.shape[0] // tile_size
    tok = tok.reshape(num_tiles, tile_size)
    exp = exp.reshape(num_tiles, tile_size)

    used = (torch.zeros((num_tokens,), dtype=used_dt, device=dev),
            torch.zeros((num_experts,), dtype=used_dt, device=dev))
    matched, conflicts, taken = [], [], []
    for i in range(num_tiles):
        used, mt, cf, fb = engine.tile_pass_capacitated(
            used[0], used[1], tok[i], exp[i],
            cap_u=token_budget, cap_v=expert_capacity,
            vector_rounds=vector_rounds, conflict_method=conflict_method,
        )
        matched.append(mt)
        conflicts.append(cf)
        taken.append(bool(fb))  # host-sync: ok — fb is a CPU flag, no wait
    if num_tiles:
        accept = torch.cat(matched)[:m]
    else:
        accept = torch.zeros((0,), dtype=torch.bool, device=dev)
    if with_stats:
        total = (torch.stack(conflicts).sum(dtype=torch.int32) if num_tiles
                 else torch.zeros((), dtype=torch.int32, device=dev))
        stats = {
            "conflicts": total,
            "fallback_tiles": torch.tensor(sum(taken), dtype=torch.int32,
                                           device=dev),
        }
        return accept, stats
    return accept
