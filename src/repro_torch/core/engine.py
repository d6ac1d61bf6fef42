"""The shared first-claim engine, unit-capacity subset (port of
``repro.core.engine``).

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
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.statespec import StateSpec, resolve as resolve_spec

ACC = 0
MCHD = 2

BlockedFn = Callable[[torch.Tensor], torch.Tensor]


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


def run_first_claim_rounds(
    u: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    read_state: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    apply_commits: Callable[[torch.Tensor], None],
    vector_rounds: int,
    blocked_fn: Optional[BlockedFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unrolled round loop over one tile (unit capacity).

    ``read_state() -> (state[u], state[v])`` and ``apply_commits(commit)``
    close over the caller's state. Returns ``(matched bool[T], conflicts
    int32[T])``: commits over the rounds and the per-edge count of rounds
    spent blocked."""
    t = u.shape[0]
    if blocked_fn is None:
        blocked_fn = blocked_from_matrix(share_matrix(u, v, valid))
    matched = torch.zeros((t,), dtype=torch.bool, device=u.device)
    conflicts = torch.zeros((t,), dtype=torch.int32, device=u.device)
    for _ in range(vector_rounds):
        a, b = read_state()
        commit, blocked = first_claim_commit(a, b, valid, matched, blocked_fn)
        apply_commits(commit)
        matched = matched | commit
        conflicts = conflicts + blocked.to(torch.int32)
    return matched, conflicts


def greedy_fallback_rounds(
    state,
    u: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    matched: torch.Tensor,
    blocked_fn: BlockedFn,
    *,
    gather,
    scatter,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact cleanup: iterate first-claim rounds until the tile has no free
    edge. The fixpoint is the sequential index-order greedy over the tile's
    remaining edges (reference docstring, ``engine.py:579``). Returns
    ``(state, matched, fallback_taken)``, the last a CPU bool tensor (the
    loop reads it on the host anyway); ``gather(state) -> (a, b)`` and
    ``scatter(state, commit) -> state``."""

    def free_mask(a, b, matched):
        return valid & ~matched & (a == ACC) & (b == ACC)

    a, b = gather(state)
    taken = bool(free_mask(a, b, matched).any())
    go = taken
    while go:
        commit, _blocked = first_claim_commit(a, b, valid, matched, blocked_fn)
        state = scatter(state, commit)
        matched = matched | commit
        a, b = gather(state)
        go = bool(free_mask(a, b, matched).any())
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
    if backend == "cuda":
        if u_rows.device.type != "cuda":
            raise ValueError("backend='cuda' needs CUDA tensors")
        from repro_torch.kernels.skipper_match.kernel import window_tier

        state0 = torch.zeros((num_rows, window), dtype=spec.vmem_dtype,
                             device=u_rows.device)
        return window_tier(u_rows, v_rows, state0, tile_size=tile_size,
                           vector_rounds=vector_rounds, spec=spec)
    if backend == "torch":
        from repro_torch.kernels.skipper_match.ref import make_ref_pipeline

        run = make_ref_pipeline(window, vector_rounds, spec=spec)
        states, matched, conflicts = run(
            u_rows.reshape(num_rows, tiles_per_window, tile_size),
            v_rows.reshape(num_rows, tiles_per_window, tile_size),
        )
        return (states, matched.reshape(u_rows.shape),
                conflicts.reshape(u_rows.shape))
    raise ValueError(f"unknown backend {backend!r}")
