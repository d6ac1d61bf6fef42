"""EMS-family baselines the paper compares against, §II-C and §II-D (port
of ``repro.core.ems``).

* ``ems_israeli_itai`` — randomized Endpoints' Mutual Selection [1]: every
  round each vertex selects its minimum-priority live incident edge under a
  fresh random permutation of edge priorities; mutually-selected edges
  commit; repeat. The per-round permutation is the randomization overhead
  the paper highlights (§III), and it is charged to the counters.
* ``ems_idmm`` — Internally-Deterministic MM [4]: the same rounds with the
  edge id as the fixed priority, so the output is deterministic and no
  per-round randomization is paid.
* ``sidmm`` — Sampling-based IDMM [7] (GBBS "RandomGreedy"): the
  globally-permuted edge stream is processed in prefix batches; each batch
  is resolved to completion with IDMM rounds against the global state.

These reproduce the paper's Table I / Fig. 7 contrasts: EMS makes several
passes over live edges plus scatter traffic per round. All are mask-based
(no materialized pruning; masking under-counts EMS memory traffic, in the
baselines' favour).

Counters are int32, as the reference's: they hold only below 2^31
accesses, and wrap above (Israeli–Itai adds at least 4m a round, IDMM at
least 2m).

Differences from the reference, value-preserving where stated:

* ``lax.while_loop`` is a Python loop whose test reads the live count on
  the host once a round.
* The reference draws its permutations with JAX's generator
  (``fold_in(PRNGKey(0), round)`` per round for Israeli–Itai,
  ``PRNGKey(seed)`` over the padded stream for SIDMM), which torch cannot
  reproduce. ``ems_israeli_itai(priorities=...)`` and ``sidmm(perm=...)``
  take them from the caller (the tests feed the reference's own, and then
  every output and counter is bit-equal); without them the port draws
  ``torch.randperm`` from a ``torch.Generator`` seeded with ``seed`` on
  the entry point's device.

Every entry point runs on ``device`` (``None``: the card, raising without
one).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.types import ACC, MCHD, STATE_DTYPE, Counters, MatchResult
from repro_torch.device import resolve_device
from repro_torch.graphs.partition import pad_edges
from repro_torch.graphs.types import EdgeList

_INF = torch.iinfo(torch.int32).max
#: the reference's round cap of the EMS loop
MAX_ROUNDS = 128

PriorityFn = Callable[[int], torch.Tensor]


def _mutual_selection_round(
    state: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    decided: torch.Tensor,
    priority: torch.Tensor,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EMS round: vertex-side scatter-min of priorities into an
    ``(n + 1)``-long buffer whose slot ``n`` takes the dead edges, then a
    commit on mutual selection. ``state`` is updated in place.

    ``priority`` must be unique over live edges (a permutation or the edge
    index), otherwise two equal-priority edges could both win a vertex.
    Returns ``(commit bool[m], live count int64)``."""
    su = state[torch.where(valid, u, 0).long()]
    sv = state[torch.where(valid, v, 0).long()]
    live = valid & ~decided & (su == ACC) & (sv == ACC)

    pri = torch.where(live, priority, _INF)
    iu = torch.where(live, u, n).long()
    iv = torch.where(live, v, n).long()
    best = torch.full((n + 1,), _INF, dtype=torch.int32, device=u.device)
    best.scatter_reduce_(0, iu, pri, "amin")
    best.scatter_reduce_(0, iv, pri, "amin")
    commit = live & (best[iu] == pri) & (best[iv] == pri)

    # reference: .at[where(commit, u, n)].set(MCHD, mode="drop"), twice
    hit = torch.zeros((n + 1,), dtype=torch.bool, device=u.device)
    true = torch.ones((), dtype=torch.bool, device=u.device)
    hit.index_put_((torch.where(commit, u, n).long(),), true)
    hit.index_put_((torch.where(commit, v, n).long(),), true)
    state.masked_fill_(hit[:n], MCHD)
    return commit, live.sum()


def _i32(x, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=dev)


def _ems(edges: EdgeList, randomize: bool, priorities: Optional[PriorityFn],
         seed: int, dev: torch.device,
         max_rounds: int = MAX_ROUNDS) -> MatchResult:
    n, m = edges.num_vertices, edges.num_edges
    e = edges.to(dev).canonical()
    valid = (e.u != e.v) & (e.u >= 0)
    if randomize and priorities is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def priorities(_round: int) -> torch.Tensor:
            return torch.randperm(m, generator=gen, device=dev).to(
                torch.int32)
    idx = torch.arange(m, dtype=torch.int32, device=dev)

    state = torch.full((n,), ACC, dtype=STATE_DTYPE, device=dev)
    mask = torch.zeros((m,), dtype=torch.bool, device=dev)
    z = _i32(0, dev)
    loads, stores, ereads = z, z, z
    m32 = _i32(m, dev)
    rounds, live = 0, 1
    while live > 0 and rounds < max_rounds:
        pri = priorities(rounds).to(dev) if randomize else idx
        commit, live_t = _mutual_selection_round(
            state, e.u, e.v, valid, mask, pri, n)
        mask = mask | commit
        live32 = live_t.to(torch.int32)
        # per round: rescan all edges (topology), 2 state loads per edge,
        # 2 scatter-min + 2 selection reads per live edge, 2 stores per
        # commit, plus the randomization pass (1 write + 1 read per edge)
        ereads = ereads + m32
        loads = loads + 2 * m32 + 4 * live32 + (2 * m32 if randomize else 0)
        stores = stores + 2 * live32 + 2 * commit.sum().to(torch.int32)
        rounds += 1
        live = int(live_t)  # host-sync: ok — the round loop's test
    counters = Counters(edge_reads=ereads, state_loads=loads,
                        state_stores=stores, rounds=_i32(rounds, dev))
    return MatchResult(match_mask=mask, state=state, counters=counters)


def ems_israeli_itai(edges: EdgeList, seed: int = 0,
                     priorities: Optional[PriorityFn] = None,
                     device=None) -> MatchResult:
    """Randomized EMS (Israeli–Itai) on ``device``. ``priorities(round)``
    gives round ``round``'s int32[m] permutation of edge priorities; by
    default ``torch.randperm`` from a generator seeded with ``seed``."""
    dev = resolve_device(device, "cuda", "ems_israeli_itai")
    return _ems(edges, True, priorities, seed, dev)


def ems_idmm(edges: EdgeList, device=None) -> MatchResult:
    """Internally-deterministic EMS (IDMM) on ``device``: the edge id is
    the priority. Bit-equal to the reference, counters included."""
    dev = resolve_device(device, "cuda", "ems_idmm")
    return _ems(edges, False, None, 0, dev)


def sidmm(edges: EdgeList, batch_size: int = 4096, seed: int = 0,
          perm: Optional[torch.Tensor] = None, device=None) -> MatchResult:
    """Sampling/prefix-batched IDMM (the paper's main competitor) on
    ``device``.

    The padded edge stream is permuted once (``perm``, int64[mp] over the
    stream padded to a multiple of ``batch_size``; by default
    ``torch.randperm`` seeded with ``seed``), then processed in prefix
    batches; each batch runs IDMM rounds to completion against the global
    state. Each round ends on a host read of the batch's live count."""
    dev = resolve_device(device, "cuda", "sidmm")
    n, m = edges.num_vertices, edges.num_edges
    e = pad_edges(edges.to(dev).canonical(), batch_size)
    mp = e.num_edges
    if perm is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        perm = torch.randperm(mp, generator=gen, device=dev)
    perm = perm.to(dev).long()
    if perm.shape != (mp,):
        raise ValueError(f"perm must be int64[{mp}] (the stream padded to a "
                         f"multiple of batch_size), got {tuple(perm.shape)}")
    num_batches = mp // batch_size
    ub = e.u[perm].reshape(num_batches, batch_size)
    vb = e.v[perm].reshape(num_batches, batch_size)
    idx = torch.arange(batch_size, dtype=torch.int32, device=dev)
    b32 = _i32(batch_size, dev)

    state = torch.full((n,), ACC, dtype=STATE_DTYPE, device=dev)
    # charge the one-time global permutation: 1 read + 1 write per slot
    loads = 2 * _i32(mp, dev)
    z = _i32(0, dev)
    stores, ereads = z, z
    rounds = 0
    masks = []
    for b in range(num_batches):
        u, v = ub[b], vb[b]
        valid = (u != v) & (u >= 0)
        mask = torch.zeros((batch_size,), dtype=torch.bool, device=dev)
        live = 1
        while live > 0:
            commit, live_t = _mutual_selection_round(
                state, u, v, valid, mask, idx, n)
            mask = mask | commit
            live32 = live_t.to(torch.int32)
            ereads = ereads + b32
            loads = loads + 2 * b32 + 4 * live32
            stores = stores + 2 * live32 + 2 * commit.sum().to(torch.int32)
            rounds += 1
            live = int(live_t)  # host-sync: ok — the batch loop's test
        masks.append(mask)
    mask_p = (torch.cat(masks) if masks
              else torch.zeros((0,), dtype=torch.bool, device=dev))
    # un-permute the mask back to stream order
    out = torch.zeros((mp,), dtype=torch.bool, device=dev)
    out[perm] = mask_p
    counters = Counters(edge_reads=ereads, state_loads=loads,
                        state_stores=stores, rounds=_i32(rounds, dev))
    return MatchResult(match_mask=out[:m], state=state, counters=counters)
