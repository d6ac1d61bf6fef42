"""The shared first-claim engine (port of ``repro.core.engine``): the
unit-capacity rounds of the matcher, the slab pass that walks them
(``stream_pass``) and the capacitated first-K-claim rounds of the
b-matching (``tile_pass_capacitated``).

Every matcher enforces the paper's invariant (Alg. 1): every edge is decided
(matched / dead) at the moment it is touched, and an edge is dead only if
one of its endpoints is already MCHD. The vectorized form is the
*first-claim round* over a tile of T edges:

    free_i    = valid, undecided, both endpoints ACC
    blocked_i = exists j < i in the tile: free_j and edges i, j share an endpoint
    commit_i  = free_i and not blocked_i      # mutually endpoint-disjoint

``blocked`` has three interchangeable implementations computing the same
function (tests pin bit-equality across them and against the reference):
``share_matrix`` + ``blocked_from_matrix`` (O(T^2) compares),
``blocked_by_claim_sort`` (one sort of the tile's 2T endpoint slots) and
``blocked_by_claim_scatter`` (scatter-min into a vertex-indexed claim
array).

These are the plain PyTorch forms. They run on any device and are what the
CPU path and the card's kernel-against-plain comparisons use; the CUDA
kernels in ``kernels/skipper_match/csrc`` compute the same rounds with one
thread per lane.

Differences from the JAX reference, all value-preserving:

* JAX updates are functional; here ``tile_pass`` and ``tile_pass_pair``
  update the state they are given **in place** and return it.
* ``.at[idx].set(..., mode="drop")`` drops index ``n`` silently;
  ``index_put_`` raises on it, so the scatter writes into a hit mask that
  has a drop slot ``n`` and then fills the hit cells.
* ``.at[].min`` is ``scatter_reduce(..., "amin", include_self=True)``.
* ``lax.while_loop`` is a Python loop that reads its condition on the host.

State encoding is the paper's: ACC=0, MCHD=2. Comparisons use plain ints,
so every ``StateSpec`` width computes the same values.

The capacitated rule (reference ``engine.py:280``–``:306``, DESIGN.md §9)
works on two independent id spaces (u side / v side, e.g. MoE tokens /
experts) with per-side budgets:

    room_s(w)  = cap_s - used_s[w]
    free_i     = valid, undecided, room > 0 on BOTH sides
    rank_s(i)  = #{ free j < i : side-s id of j == side-s id of i }
    blocked_i  = rank_u(i) >= room_u(u_i)  or  rank_v(i) >= room_v(v_i)
    commit_i   = free_i and not blocked_i

``rank`` has three interchangeable forms, like ``blocked``: the triangular
same-id matrix, the per-side claim sort and the vertex-indexed one-hot
prefix.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.device import resolve_backend

ACC = 0
MCHD = 2

BlockedFn = Callable[[torch.Tensor], torch.Tensor]
RankFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def share_matrix(u: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """conflict[i, j] = True iff j < i, both valid, and edges i, j share an
    endpoint. u/v int32[T], valid bool[T]; returns bool[T, T]."""
    t = u.shape[0]
    share = (
        (u[:, None] == u[None, :])
        | (u[:, None] == v[None, :])
        | (v[:, None] == u[None, :])
        | (v[:, None] == v[None, :])
    )
    lower = torch.ones((t, t), dtype=torch.bool, device=u.device).tril(-1)
    return share & lower & valid[None, :] & valid[:, None]


def blocked_from_matrix(conflict: torch.Tensor) -> BlockedFn:
    """``blocked_fn(free)[i]`` is True iff ``free[i]`` and some free
    ``j < i`` shares an endpoint with edge i (a subset of ``free``)."""

    def blocked_fn(free):
        return (conflict & free[None, :]).any(dim=1) & free

    return blocked_fn


def blocked_by_claim_sort(u: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor, n: int) -> BlockedFn:
    """The same ``blocked`` function via the per-vertex minimum free
    claimant: edge i is blocked iff ``min(claimant(u_i), claimant(v_i)) <
    i``. One sort of the tile's 2T (vertex, edge) slots on a composite int32
    key, then O(T) per round.

    Requires ``(n + 1) * (T + 1) < 2^31`` (the int32 key); raises otherwise.
    """
    t = u.shape[0]
    if (n + 1) * (t + 1) >= 2**31:
        raise ValueError(
            f"claim-sort int32 key overflow: n={n}, tile={t}; use "
            "conflict_method='matrix' (or 'auto', which picks it)"
        )
    dev = u.device
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    verts = torch.cat([torch.where(valid, u, n), torch.where(valid, v, n)])
    verts = verts.to(torch.int32)
    eid2 = torch.cat([idx, idx])
    last = 2 * t - 1
    skey = torch.sort(verts * (t + 1) + eid2).values
    sverts = (skey // (t + 1)).contiguous()
    seid = (skey % (t + 1)).long()
    segs = torch.searchsorted(sverts, sverts)
    pu = torch.clamp(torch.searchsorted(sverts, u.contiguous()), max=last)
    pv = torch.clamp(torch.searchsorted(sverts, v.contiguous()), max=last)
    u_found = sverts[pu] == u
    v_found = sverts[pv] == v
    none = torch.full((2 * t,), t, dtype=torch.int32, device=dev)

    def blocked_fn(free):
        cand = torch.where(free[seid], seid.to(torch.int32), t)
        claim = none.scatter_reduce(0, segs, cand, "amin", include_self=True)
        cu = torch.where(u_found, claim[pu], t)
        cv = torch.where(v_found, claim[pv], t)
        return free & (torch.minimum(cu, cv) < idx)

    return blocked_fn


def blocked_by_claim_scatter(u: torch.Tensor, v: torch.Tensor,
                             valid: torch.Tensor, n: int) -> BlockedFn:
    """Same claimant function via a direct scatter-min into a
    vertex-indexed [n] claim array (wins when ``n`` is small relative to
    the tile)."""
    t = u.shape[0]
    dev = u.device
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    ug = torch.where(valid, u, 0).long()
    vg = torch.where(valid, v, 0).long()
    none = torch.full((n,), t, dtype=torch.int32, device=dev)

    def blocked_fn(free):
        cand = torch.where(free, idx, t)
        claim = none.scatter_reduce(0, ug, cand, "amin", include_self=True)
        claim = claim.scatter_reduce(0, vg, cand, "amin", include_self=True)
        return free & (torch.minimum(claim[ug], claim[vg]) < idx)

    return blocked_fn


def first_claim_commit(
    su: torch.Tensor,
    sv: torch.Tensor,
    valid: torch.Tensor,
    matched: torch.Tensor,
    blocked_fn: BlockedFn,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One first-claim round from the gathered endpoint states. Returns
    (commit, blocked); committed edges are mutually endpoint-disjoint."""
    free = valid & ~matched & (su == ACC) & (sv == ACC)
    blocked = blocked_fn(free)
    commit = free & ~blocked
    return commit, blocked


def first_k_claim_commit(
    used_u: torch.Tensor,
    used_v: torch.Tensor,
    valid: torch.Tensor,
    matched: torch.Tensor,
    rank_fn: RankFn,
    cap_u: int,
    cap_v: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One capacitated first-claim round from the gathered per-edge used
    counts (any integer width; widened to int32 here). Returns
    ``(commit, blocked)``; within a round the commits on any vertex are the
    free claimants of rank below its room, so none oversubscribes."""
    room_u = cap_u - used_u.to(torch.int32)  # state-dtype: ok — accum math
    room_v = cap_v - used_v.to(torch.int32)  # state-dtype: ok — accum math
    free = valid & ~matched & (room_u > 0) & (room_v > 0)
    rank_u, rank_v = rank_fn(free)
    blocked = free & ((rank_u >= room_u) | (rank_v >= room_v))
    commit = free & ~blocked
    return commit, blocked


def _side_rank_matrix(ids: torch.Tensor, valid: torch.Tensor):
    """rank(free)[i] = #{free j < i with ids[j] == ids[i]} from the strictly
    lower-triangular same-id matrix (O(T^2) compares)."""
    t = ids.shape[0]
    lower = torch.ones((t, t), dtype=torch.bool, device=ids.device).tril(-1)
    mat = ((ids[:, None] == ids[None, :]) & lower & valid[None, :]
           & valid[:, None])

    def rank(free):
        return (mat & free[None, :]).sum(dim=1, dtype=torch.int32)

    return rank


def _side_rank_sort(ids: torch.Tensor, valid: torch.Tensor, n: int):
    """The same rank via one sort per tile: slots sorted by (id, edge
    index); a round is then a gather and a cumsum (the exclusive prefix of
    the free mask within the edge's id run). Same int32 key bound as
    :func:`blocked_by_claim_sort`."""
    t = ids.shape[0]
    if (n + 1) * (t + 1) >= 2**31:
        raise ValueError(
            f"claim-sort int32 key overflow: n={n}, tile={t}; use "
            "conflict_method='matrix' (or 'auto', which picks it)"
        )
    dev = ids.device
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    masked = torch.where(valid, ids, n).to(torch.int32)
    order = torch.argsort(masked * (t + 1) + idx, stable=True)
    sids = masked[order].contiguous()
    starts = torch.searchsorted(sids, sids)
    pos = torch.zeros((t,), dtype=torch.long, device=dev).scatter_(
        0, order, idx.long())

    def rank(free):
        fs = free[order].to(torch.int32)
        excl = torch.cumsum(fs, 0, dtype=torch.int32) - fs
        return (excl - excl[starts])[pos]

    return rank


def _side_rank_scatter(ids: torch.Tensor, valid: torch.Tensor, n: int):
    """The same rank via a vertex-indexed [T, n] one-hot running prefix
    (O(T*n) a round: for a tiny id space, e.g. the experts)."""
    t = ids.shape[0]
    onehot = (torch.arange(n, dtype=torch.int32, device=ids.device)[None, :]
              == torch.where(valid, ids, n)[:, None])
    col = torch.clamp(torch.where(valid, ids, 0), max=n - 1).long()

    def rank(free):
        claims = (onehot & free[:, None]).to(torch.int32)
        pref = torch.cumsum(claims, 0, dtype=torch.int32) - claims
        return pref.gather(1, col[:, None])[:, 0]

    return rank


_SIDE_RANKS = {
    "matrix": lambda ids, valid, n: _side_rank_matrix(ids, valid),
    "sort": _side_rank_sort,
    "scatter": _side_rank_scatter,
}


def ranks_from_matrix(u: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor) -> RankFn:
    """Capacitated twin of :func:`blocked_from_matrix`: per-side triangular
    same-id matrices. ``rank_fn(free) -> (rank_u, rank_v)``."""
    ru, rv = _side_rank_matrix(u, valid), _side_rank_matrix(v, valid)
    return lambda free: (ru(free), rv(free))


def ranks_by_claim_sort(u: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                        n_u: int, n_v: int) -> RankFn:
    """Capacitated twin of :func:`blocked_by_claim_sort`: one sort per side
    per tile."""
    ru = _side_rank_sort(u, valid, n_u)
    rv = _side_rank_sort(v, valid, n_v)
    return lambda free: (ru(free), rv(free))


def ranks_by_claim_scatter(u: torch.Tensor, v: torch.Tensor,
                           valid: torch.Tensor, n_u: int, n_v: int) -> RankFn:
    """Capacitated twin of :func:`blocked_by_claim_scatter`: the one-hot
    prefix on both sides."""
    ru = _side_rank_scatter(u, valid, n_u)
    rv = _side_rank_scatter(v, valid, n_v)
    return lambda free: (ru(free), rv(free))


def capacitated_rank_fn(u: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                        n_u: int, n_v: int, method: str = "auto") -> RankFn:
    """The per-side rank function for :func:`first_k_claim_commit`.

    ``"auto"`` picks per side, by the reference's rule: the one-hot prefix
    for a tiny id space, claim-sort while its int32 key fits, the matrix
    beyond. ``"matrix"`` / ``"sort"`` / ``"scatter"`` force one form on
    both sides. All compute the same function."""
    t = u.shape[0]

    def pick(n):
        if n <= max(64, t // 8):
            return "scatter"
        if (n + 1) * (t + 1) < 2**31:
            return "sort"
        return "matrix"

    if method == "auto":
        mu, mv = pick(n_u), pick(n_v)
    elif method in _SIDE_RANKS:
        mu = mv = method
    else:
        raise ValueError(f"unknown conflict_method {method!r}")
    ru = _SIDE_RANKS[mu](u, valid, n_u)
    rv = _SIDE_RANKS[mv](v, valid, n_v)
    return lambda free: (ru(free), rv(free))


def run_first_claim_rounds(
    u: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    read_state: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    apply_commits: Callable[[torch.Tensor], None],
    vector_rounds: int,
    blocked_fn=None,
    capacities: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unrolled round loop over one tile.

    ``read_state() -> (a, b)`` gathers the per-edge endpoint values
    (``state[u], state[v]`` at unit capacity, the used counts
    ``used_u[u], used_v[v]`` with ``capacities=(cap_u, cap_v)``) and
    ``apply_commits(commit)`` writes a round's commits back; both close over
    the caller's state. ``blocked_fn`` is a ``blocked_*`` function at unit
    capacity (default: the share matrix) and a rank function
    (:func:`capacitated_rank_fn`) with capacities, where it is required.
    Returns ``(matched bool[T], conflicts int32[T])``: commits over the
    rounds and the per-edge count of rounds spent blocked."""
    t = u.shape[0]
    if capacities is None:
        if blocked_fn is None:
            blocked_fn = blocked_from_matrix(share_matrix(u, v, valid))

        def commit_round(a, b, matched):
            return first_claim_commit(a, b, valid, matched, blocked_fn)
    else:
        if blocked_fn is None:
            raise ValueError(
                "capacitated rounds need a rank_fn (capacitated_rank_fn)")
        cap_u, cap_v = capacities

        def commit_round(a, b, matched):
            return first_k_claim_commit(a, b, valid, matched, blocked_fn,
                                        cap_u, cap_v)

    matched = torch.zeros((t,), dtype=torch.bool, device=u.device)
    conflicts = torch.zeros((t,), dtype=torch.int32, device=u.device)
    for _ in range(vector_rounds):
        a, b = read_state()
        commit, blocked = commit_round(a, b, matched)
        apply_commits(commit)
        matched = matched | commit
        conflicts = conflicts + blocked.to(torch.int32)
    return matched, conflicts


def count_fallback(prefix: str, conflicts: torch.Tensor, vector_rounds: int,
                   edges) -> None:
    """While a profiler records, add a tier's ``edges`` (a host integer or
    a device scalar) to the counter ``<prefix>.edges`` and the edges its
    exact fallback decides to ``<prefix>.fallback_edges``
    (``repro_torch/tracing.py``). An edge is left to the fallback exactly
    when it was free and blocked in every vector round, that is when its
    conflicts equal ``vector_rounds`` (padding has none); with no vector
    round every edge is. ``conflicts`` is the tier's per-slot output, or
    ``None`` for a tier that has no slots (and 0 ``edges``): both counters
    exist from a tier's first call on, so that a counter that is missing
    means nothing was counted. The count is the span
    ``<prefix>.fallback_count``, which names its device time in the
    trace."""
    if not tracing.recording():
        return
    with tracing.span(f"{prefix}.fallback_count"):
        tracing.count_device(f"{prefix}.edges", edges)
        tracing.count_device(
            f"{prefix}.fallback_edges",
            edges if conflicts is None or not vector_rounds
            else (conflicts == vector_rounds).sum())


def greedy_fallback_rounds(
    state,
    u: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    matched: torch.Tensor,
    blocked_fn,
    *,
    gather,
    scatter,
    capacities: Optional[Tuple[int, int]] = None,
) -> Tuple[object, torch.Tensor, torch.Tensor]:
    """Exact cleanup: iterate first-claim rounds until the tile has no free
    edge. The fixpoint is the sequential index-order greedy over the tile's
    remaining edges (reference docstring, ``engine.py:579``), at unit
    capacity and with ``capacities=(cap_u, cap_v)`` alike. Returns
    ``(state, matched, fallback_taken)``, the last a CPU bool tensor (the
    loop reads it on the host anyway); ``gather(state) -> (a, b)`` and
    ``scatter(state, commit) -> state``. ``state`` is the vertex-state
    array at unit capacity, the ``(used_u, used_v)`` pair with
    capacities."""
    if capacities is None:

        def free_mask(a, b, matched):
            return valid & ~matched & (a == ACC) & (b == ACC)

        def commit_round(a, b, matched):
            return first_claim_commit(a, b, valid, matched, blocked_fn)
    else:
        cap_u, cap_v = capacities

        def free_mask(a, b, matched):
            return valid & ~matched & (a < cap_u) & (b < cap_v)

        def commit_round(a, b, matched):
            return first_k_claim_commit(a, b, valid, matched, blocked_fn,
                                        cap_u, cap_v)

    a, b = gather(state)
    # the loop's test waits for the card once a round (PERF.md section 5)
    taken = bool(free_mask(a, b, matched).any())  # host-sync: ok — loop test
    go = taken
    while go:
        commit, _blocked = commit_round(a, b, matched)
        state = scatter(state, commit)
        matched = matched | commit
        a, b = gather(state)
        go = bool(free_mask(a, b, matched).any())  # host-sync: ok — loop
    return state, matched, torch.tensor(taken)


def _blocked_impl(u, v, valid, n: int, conflict_method: str) -> BlockedFn:
    t = u.shape[0]
    if conflict_method == "auto":
        if u.device.type == "cuda":
            # fewest launches per round; a T x T mask is cheap on the card
            conflict_method = "matrix"
        elif n <= 16 * t:
            conflict_method = "scatter"
        elif (n + 1) * (t + 1) < 2**31:
            conflict_method = "sort"
        else:
            conflict_method = "matrix"
    if conflict_method == "scatter":
        return blocked_by_claim_scatter(u, v, valid, n)
    if conflict_method == "sort":
        return blocked_by_claim_sort(u, v, valid, n)
    if conflict_method == "matrix":
        return blocked_from_matrix(share_matrix(u, v, valid))
    raise ValueError(f"unknown conflict_method {conflict_method!r}")


def tile_pass(
    state: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    n: int,
    vector_rounds: int,
    fallback: bool = True,
    conflict_method: str = "auto",
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One edge tile (first-claim vector rounds + exact fallback) against a
    full ``state`` of ``n`` vertices, which is updated **in place**.

    u/v int32[T] endpoint ids; invalid edges are ``u < 0`` or ``u == v``.
    ``conflict_method`` picks the blocked implementation (``"auto"``,
    ``"scatter"``, ``"sort"``, ``"matrix"``); all give the same output.
    ``"auto"`` takes the reference's rule on the CPU and the share matrix
    on a CUDA device, where it needs the fewest launches.
    With ``spec`` the conflicts are narrowed to ``spec.counter``.

    Returns ``(state, matched bool[T], conflicts[T], fallback_taken)``.
    """
    valid = (u != v) & (u >= 0)
    blocked_fn = _blocked_impl(u, v, valid, n, conflict_method)
    true = torch.ones((), dtype=torch.bool, device=u.device)
    ug = torch.where(valid, u, 0).long()
    vg = torch.where(valid, v, 0).long()

    def gather(st):
        return st[ug], st[vg]

    def scatter(st, commit):
        # reference: .at[where(commit, u, n)].set(MCHD, mode="drop"). Every
        # lane writes True into a hit mask with a drop slot n (identical
        # values, so the writes commute), then committed cells become MCHD;
        # no boolean indexing, so no host sync on the card.
        hit = torch.zeros((n + 1,), dtype=torch.bool, device=st.device)
        for ids in (u, v):
            ids = torch.where(commit, ids, n).long()
            hit.index_put_((torch.where(ids < 0, ids + n, ids),), true)
        st.masked_fill_(hit[:n], MCHD)
        return st

    def read_state():
        return gather(state)

    def apply_commits(commit):
        scatter(state, commit)

    matched, conflicts = run_first_claim_rounds(
        u, v, valid, read_state, apply_commits, vector_rounds, blocked_fn
    )
    if spec is not None:
        spec.validate_rounds(vector_rounds)
        conflicts = conflicts.to(spec.counter_dtype)
    if not fallback:
        return state, matched, conflicts, torch.tensor(False)
    state, matched, taken = greedy_fallback_rounds(
        state, u, v, valid, matched, blocked_fn, gather=gather, scatter=scatter
    )
    return state, matched, conflicts, taken


def tile_pass_pair(
    state_rows: torch.Tensor,
    u_loc: torch.Tensor,
    v_loc: torch.Tensor,
    blk_u: int,
    blk_v: int,
    *,
    window: int,
    vector_rounds: int,
    fallback: bool = True,
    conflict_method: str = "auto",
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-block variant of :func:`tile_pass`: the global tier's decision
    step for one tile whose endpoints live in rows ``blk_u`` and ``blk_v``
    of ``state_rows`` ``[num_windows, window]`` (updated **in place**).

    Ids are the schedule's offset-local encoding: ``u_loc`` in
    ``[0, window)``; ``v_loc`` plus ``window`` for a cross-block pair. The
    tile runs on the 2W concatenation of the two rows, which are written
    back v-half first, u-half second (a same-block pair's u-half wins).

    Returns ``(state_rows, matched, conflicts, fallback_taken)``."""
    blk_u, blk_v = int(blk_u), int(blk_v)
    pair = torch.cat([state_rows[blk_u], state_rows[blk_v]])
    pair, matched, conflicts, taken = tile_pass(
        pair, u_loc, v_loc, n=2 * window, vector_rounds=vector_rounds,
        fallback=fallback, conflict_method=conflict_method, spec=spec,
    )
    state_rows[blk_v] = pair[window:]
    state_rows[blk_u] = pair[:window]
    return state_rows, matched, conflicts, taken


def tile_pass_capacitated(
    used_u: torch.Tensor,
    used_v: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    cap_u: int,
    cap_v: int,
    vector_rounds: int,
    fallback: bool = True,
    conflict_method: str = "auto",
    spec: Optional[StateSpec] = None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """Capacitated twin of :func:`tile_pass`: one edge tile against the
    per-side used counts ``used_u`` [n_u] and ``used_v`` [n_v] (any integer
    width that holds the budgets) with budgets ``cap_u`` and ``cap_v``.

    u, v: int32[T] per-side ids, ``-1`` padding (valid is
    ``(u >= 0) & (v >= 0)``; the sides are independent id spaces, so no
    ``u != v`` check). The used counts are not changed in place.

    Returns ``((used_u, used_v), matched bool[T], conflicts[T],
    fallback_taken)``. Rounds plus fallback reach the sequential index-order
    greedy b-matching of the tile, so a loop over tiles carrying the used
    counts is the sequential greedy over the whole stream."""
    valid = (u >= 0) & (v >= 0)
    n_u, n_v = used_u.shape[0], used_v.shape[0]
    rank_fn = capacitated_rank_fn(u, v, valid, n_u, n_v, conflict_method)
    ug = torch.where(valid, u, 0).long()
    vg = torch.where(valid, v, 0).long()
    one = torch.ones(u.shape, dtype=torch.int32, device=u.device)

    def gather(st):
        return st[0][ug], st[1][vg]

    def added(used, ids, commit, n):
        # reference: .at[where(commit, ids, n)].add(1, mode="drop"); slot n
        # of an int32 hit count is the drop slot
        hits = torch.zeros((n + 1,), dtype=torch.int32, device=ids.device)
        hits.scatter_add_(0, torch.where(commit, ids, n).long(), one)
        return used + hits[:n].to(used.dtype)

    def scatter(st, commit):
        return added(st[0], u, commit, n_u), added(st[1], v, commit, n_v)

    cell = [(used_u, used_v)]

    def read_state():
        return gather(cell[0])

    def apply_commits(commit):
        cell[0] = scatter(cell[0], commit)

    matched, conflicts = run_first_claim_rounds(
        u, v, valid, read_state, apply_commits, vector_rounds, rank_fn,
        capacities=(cap_u, cap_v))
    state = cell[0]
    if spec is not None:
        spec.validate_rounds(vector_rounds)
        conflicts = conflicts.to(spec.counter_dtype)
    if not fallback:
        return state, matched, conflicts, torch.tensor(False)
    state, matched, taken = greedy_fallback_rounds(
        state, u, v, valid, matched, rank_fn, gather=gather, scatter=scatter,
        capacities=(cap_u, cap_v))
    return state, matched, conflicts, taken


def stream_pass(
    state: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    n: int,
    vector_rounds: int,
    tile_size: int,
    conflict_method: str = "auto",
    spec: Optional[StateSpec] = None,
    backend: Optional[str] = None,
    checked: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy first-claim pass over an [L] edge slab in stream order, tiled
    contiguously (slot ``t * tile_size + l``; ``L % tile_size == 0``; -1
    marks padding): the sequential single pass over the slab's edges at
    tile granularity, against ``state`` [n], which is updated **in place**
    (the reference's scan carry is functional: a caller that needs the old
    state passes a copy).

    The one slab pass of the distributed matcher's LOCAL PASS and REPLAY
    (``core/distributed.py``) and of the fault recovery's residual replay
    (``core/faults.py``), so the recovery cannot drift from the protocol
    it recovers.

    ``backend="torch"`` loops :func:`tile_pass` over the tiles (any
    device); ``"cuda"`` runs the slab through the global-tier kernel as
    one state row of ``n`` cells with every tile the pair (0, 0)
    (``kernels/skipper_match/kernel.tiles_on_card``), at the state's own
    width. ``None``: by the state's device (``device.resolve_backend``).
    On the card an invalid slot (``u < 0`` or ``u == v``) is written as
    (-1, -1) first, and the ids are range checked, unless ``checked=True``
    says the caller has done both.

    Returns ``(state, matched bool[L], conflicts[L])``: conflicts int32, or
    ``spec.counter`` when a spec is passed; the state keeps its dtype.
    """
    num_tiles = u.shape[0] // tile_size
    ut = u.reshape(num_tiles, tile_size)
    vt = v.reshape(num_tiles, tile_size)
    if resolve_backend(backend, state.device) == "cuda":
        from repro_torch.kernels.skipper_match.kernel import tiles_on_card

        if not checked:
            valid = (ut >= 0) & (ut != vt)
            ut = torch.where(valid, ut, -1)
            vt = torch.where(valid, vt, -1)
        matched, conflicts = tiles_on_card(
            state, ut.contiguous(), vt.contiguous(), vector_rounds,
            spec if spec is not None else StateSpec(counter="int32"),
            check_ids=not checked)
        return state, matched.reshape(-1), conflicts.reshape(-1)
    cdt = torch.int32 if spec is None else spec.counter_dtype
    matched = torch.zeros((num_tiles, tile_size), dtype=torch.bool,
                          device=u.device)
    conflicts = torch.zeros((num_tiles, tile_size), dtype=cdt,
                            device=u.device)
    for k in range(num_tiles):
        _, matched[k], conflicts[k], _ = tile_pass(
            state, ut[k], vt[k], n=n, vector_rounds=vector_rounds,
            conflict_method=conflict_method, spec=spec,
        )
    return state, matched.reshape(-1), conflicts.reshape(-1)


def window_tier_pass(
    u_rows: torch.Tensor,
    v_rows: torch.Tensor,
    *,
    window: int,
    tiles_per_window: int,
    tile_size: int,
    vector_rounds: int,
    backend: str,
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the window tier of a two-tier schedule: each row is one window's
    tile stream, matched from an all-ACC window-local state.

    ``backend="cuda"`` launches the hand-written window-tier kernel (CUDA
    tensors only); ``backend="torch"`` runs the plain version
    (``ref.make_ref_pipeline``) on any device.

    Returns ``(states spec.vmem[num_rows, window], matched, conflicts)``,
    the latter two ``spec.counter`` of ``u_rows``'s shape.
    """
    spec = resolve_spec(spec)
    num_rows = u_rows.shape[0]
    if resolve_backend(backend, u_rows.device) == "cuda":
        from repro_torch.kernels.skipper_match.kernel import window_tier

        state0 = torch.zeros((num_rows, window), dtype=spec.vmem_dtype,
                             device=u_rows.device)
        return window_tier(u_rows, v_rows, state0, tile_size=tile_size,
                           vector_rounds=vector_rounds, spec=spec)
    from repro_torch.kernels.skipper_match.ref import make_ref_pipeline

    run = make_ref_pipeline(window, vector_rounds, spec=spec)
    states, matched, conflicts = run(
        u_rows.reshape(num_rows, tiles_per_window, tile_size),
        v_rows.reshape(num_rows, tiles_per_window, tile_size),
    )
    return (states, matched.reshape(u_rows.shape),
            conflicts.reshape(u_rows.shape))
