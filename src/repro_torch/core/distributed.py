"""Skipper across ranks on ``torch.distributed``: the ranks play the
paper's threads (port of ``repro.core.distributed``; DESIGN.md §8, §11).

Two schedules share one protocol core (:func:`_make_round_fn`):

**Dispersed** (``reorder="none"``, no ``window``: the paper's §IV-C
deal): every edge block goes through the four-step round below, as a
paper thread scans its blocks.

**Locality-sharded** (``reorder=`` / ``window=`` / a prebuilt schedule):
the stream is renumbered, bucketed into a two-tier ``WindowSchedule`` and
dealt by ``graphs/partition.partition_schedule``. Each rank resolves its
dealt window rows alone through ``engine.window_tier_pass`` (the window
tier kernel on the card); one O(V) collective over the per-row states,
``StateSpec.combine_rows`` at the spec's wire width, rebuilds the
committed state on every rank; only the global tier runs the protocol.

Protocol per round (paper Alg. 1 across ranks):

1. LOCAL PASS: each rank matches its next block, behind its retry buffer,
   against a copy of the committed state (``engine.stream_pass``; the
   global-tier kernel on the card). Its commits are *proposals*.
2. GATHER: one ``all_gather`` moves the proposals (stream indices, plus
   endpoints on the dispersed path) to every rank, position-major: slot
   ``j`` of rank ``d`` lands at ``j * D + d``.
3. REPLAY: every rank applies the gathered proposals in that order with
   the same first-claim pass, in place on the committed state, so the
   state stays the same on every rank; a proposal loses only to an
   earlier winner.
4. REQUEUE: edges the local pass killed through a provisional claim that
   then lost, and still free after the replay, enter the retry buffer
   (stable order).

Output is deterministic given the schedule, and equal bit for bit to the
JAX package's at the same D: the mask, the state, the ``Counters`` and
the :class:`DistStats`. At D = 1 the locality-sharded run equals
``skipper_match`` on the same schedule.

Ranks: ``group=None`` with no initialised process group is one rank, and
every collective is the identity; otherwise the group's world size is D
and its rank plays the reference's ``axis_index``. With NCCL the tensors
live on each rank's current CUDA device; with gloo on the CPU.

The rounds never wait for the host: the id ranges are checked once, up
front, and every count stays on the device until the run ends.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import ACC, MCHD, stream_pass, window_tier_pass
from repro_torch.core.faults import (
    CORRUPT,
    FaultPlan,
    corruption_mask,
    detect_residual,
    proposal_drop_mask,
    residual_replay,
)
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.core.types import Counters, MatchResult
from repro_torch.core.validate import check_matching
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.graphs.partition import (
    DeviceSchedule,
    dispersed_blocks,
    locality_device_schedule,
    partition_schedule,
)
from repro_torch.graphs.types import EdgeList
from repro_torch.graphs.windows import WindowSchedule

__all__ = ["DistStats", "distributed_skipper"]

#: bounded in-protocol escalation: at most this many re-runs with regrown
#: knobs before the ladder drops to the residual replay (DESIGN.md §11)
_MAX_ESCALATIONS = 2

#: the round counts each rank keeps (int32, summed over the rounds; the
#: work counters are linear in them, see ``_aggregate_stats``): proposals,
#: requeues and valid slots of its local passes, retry overflow,
#: conflicts of its valid slots; then the replay's valid slots and winners,
#: the same on every rank. The wire bytes are counted on the host.
_RAW = ("props", "req", "nvalid", "ovf", "nconf", "nrepl", "nwin")
#: the entries summed over ranks at the end (the rest are counted once)
_PER_RANK = 5


@dataclasses.dataclass(frozen=True)
class DistStats:
    """Per-run distributed accounting, summed over ranks (int32 0-d
    tensors on the run's device).

    The last four fields are the degradation ledger (DESIGN.md §11): zero
    on a healthy ``on_fault="raise"`` run; filled by ``"report"``
    (detection), ``"recover"`` (what the ladder did) and ``verify=True``.
    """

    proposals: torch.Tensor        # total proposals sent
    lost_proposals: torch.Tensor   # proposals that lost the replay
    requeued: torch.Tensor         # edges requeued (the spin-wait analogue)
    retry_overflow: torch.Tensor   # edges a full retry buffer dropped (0)
    undrained: torch.Tensor        # retry entries alive after the drain (0)
    gathered_bytes: torch.Tensor   # collective payload bytes over the run:
    #   int32 proposal gathers + the O(V) state assembly at the spec's wire
    #   width (was `gathered_ints`, an i32 count)
    recovery_attempts: "torch.Tensor | int" = 0  # ladder steps that did work
    residual_edges: "torch.Tensor | int" = 0     # valid edges left undecided
    recovered_matches: "torch.Tensor | int" = 0  # matches the replay added
    corrupted_cells: "torch.Tensor | int" = 0    # out-of-domain cells seen

    @property
    def gathered_ints(self):
        """Deprecated alias (one release): the old i32-word count. The
        payload is no longer all-i32; use :attr:`gathered_bytes`."""
        warnings.warn(
            "DistStats.gathered_ints is deprecated; use gathered_bytes "
            "(the wire payload is no longer uniformly int32)",
            DeprecationWarning, stacklevel=2,
        )
        return self.gathered_bytes // 4

    def _tripwires(self) -> Tuple[int, int]:
        both = torch.stack([torch.as_tensor(self.retry_overflow),
                            torch.as_tensor(self.undrained)])
        ovf, und = both.tolist()  # host-sync: ok — one fetch of both
        return ovf, und

    @property
    def ok(self) -> bool:
        """True iff the must-be-zero invariants held: no retry overflow and
        nothing left undrained. Reading it waits for the card (one fetch
        of both counts)."""
        ovf, und = self._tripwires()
        return ovf == 0 and und == 0

    def raise_if_bad(self) -> None:
        """Raise ``RuntimeError`` if a must-be-zero invariant tripped
        (waits for the card, like :attr:`ok`)."""
        ovf, und = self._tripwires()
        if ovf != 0 or und != 0:
            raise RuntimeError(
                "distributed matching violated its must-be-zero invariants: "
                f"retry_overflow={ovf} (edges dropped by a full retry "
                f"buffer), undrained={und} (retry entries alive after the "
                "drain rounds) — the matching may be non-maximal. Increase "
                "block_size and/or drain_rounds, or run on_fault='recover' "
                "to complete the matching."
            )


# ------------------------------------------------------------ ranks ----
def _ranks(group) -> Tuple[object, int, int]:
    """``(group, D, rank)``; ``(None, 1, 0)`` without a process group."""
    import torch.distributed as dist

    if group is None and not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0
    return group, dist.get_world_size(group), dist.get_rank(group)


def _all_gather(x: torch.Tensor, group, num_devices: int) -> torch.Tensor:
    """Every rank's ``x`` [..., L], position-major along the last axis:
    element ``j`` of rank ``d`` lands at ``j * D + d`` (the reference's
    ``all_gather(x).T.reshape(-1)``)."""
    if num_devices == 1 and group is None:
        return x
    import torch.distributed as dist

    outs = [torch.empty_like(x) for _ in range(num_devices)]
    dist.all_gather(outs, x.contiguous(), group=group)
    return torch.stack(outs, dim=-1).reshape(*x.shape[:-1], -1)


def _all_sum(x: torch.Tensor, group, num_devices: int) -> torch.Tensor:
    if num_devices == 1 and group is None:
        return x
    import torch.distributed as dist

    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _i32(x: int) -> int:
    """``x`` wrapped to int32, as the reference's int32 counters wrap."""
    return (int(x) + 2**31) % 2**32 - 2**31


# ------------------------------------------------------------ protocol --
def _make_round_fn(
    *,
    n: int,
    mask_len: int,
    group,
    num_devices: int,
    rank: int,
    vector_rounds: int,
    tile_size: int,
    block: int,
    backend: str,
    device: torch.device,
    edge_lookup=None,
    faults: Optional[FaultPlan] = None,
):
    """Build the four-step round shared by both schedules.

    The carry is ``(state, mask, retry, stats)``: ``state`` the committed
    state [n], updated in place by the replay; ``mask`` bool[mask_len + 1]
    of replay winners by stream index (the last slot is the guard the
    reference's ``mode="drop"`` scatter drops); ``retry`` int32[3, cap]
    (u, v, stream index; -1 empty); ``stats`` int32[len(_RAW)], updated
    in place. A block is int32[3, block] the same way. Only valid slots
    count, so padding and drain rounds add nothing.

    ``edge_lookup``: ``(lu, lv)`` mapping a stream index to its endpoints,
    where the dealt stream is schedule data every rank holds (the
    locality-sharded global tier): a proposal then gathers as its index
    alone, 4 bytes a slot instead of 12.

    ``faults``: ``drop_proposals`` drops sent slots on the wire (the rank
    still believes it proposed, so the edge is neither replayed nor
    requeued), ``lose_shard`` swallows one rank's proposals,
    ``truncate_retry`` caps the retry buffer.

    Returns ``(one_round, round_bytes)``: the round and the bytes every
    round gathers over all ranks."""
    cap = block  # retry buffer capacity
    cap_eff = cap
    if faults is not None and faults.truncate_retry is not None:
        cap_eff = min(cap, faults.truncate_retry)
    slab = block + cap
    slab_pad = (-slab) % tile_size
    slab_t = slab + slab_pad
    pad = torch.full((3, slab_pad), -1, dtype=torch.int32, device=device)
    dmask = None
    if faults is not None and faults.drop_proposals > 0.0:
        dmask = proposal_drop_mask(faults, mask_len, device)
    lost = (faults is not None and faults.lose_shard is not None
            and rank == faults.lose_shard % num_devices)
    hi = n - 1
    pass_kw = dict(n=n, vector_rounds=vector_rounds, tile_size=tile_size,
                   backend=backend, checked=True)
    if edge_lookup is not None:
        lookup = torch.stack(edge_lookup)  # [2, stream]: u and v by index
        last = lookup.shape[1] - 1
        round_bytes = 4 * slab_t * num_devices  # one i32 index a slot
    else:
        round_bytes = 3 * 4 * slab_t * num_devices  # (u, v, idx) i32s

    def one_round(carry, blk):
        state, mask, retry, stats = carry

        # 1. LOCAL PASS on [retry ++ block], against a copy: the kernel
        # writes its state row in place, and the committed state must
        # stay the pre-round one
        slab_uvi = torch.cat([retry, blk, pad], dim=1)
        u, v, idx = slab_uvi[0], slab_uvi[1], slab_uvi[2]
        _, proposed, local_conf = stream_pass(state.clone(), u, v,
                                              **pass_kw)
        valid = (u >= 0) & (u != v)
        open_ = valid & ~proposed
        ends = slab_uvi[:2].clamp(0, hi).long()
        # dead against the committed (pre-round) state is dead for good;
        # the rest of the open slots died by a provisional claim
        dead_prov = open_ & ~(state[ends] == MCHD).any(0)

        # 2. GATHER the proposals, position-major
        sent = proposed
        if dmask is not None:
            # FAULT: the slot is dropped on the wire; the rank believes it
            # proposed (dead_prov stays False), so the edge is lost
            sent = sent & ~dmask[idx.clamp(0, mask_len - 1).long()]
        if lost:
            # FAULT: this rank's proposals are swallowed
            sent = torch.zeros_like(sent)
        if edge_lookup is not None:
            gi = _all_gather(torch.where(sent, idx, -1), group, num_devices)
            gj = gi.clamp(0, last).long()
            guv = torch.where(gi >= 0, lookup[:, gj], -1)
        else:
            gathered = _all_gather(torch.where(sent, slab_uvi, -1), group,
                                   num_devices)
            guv, gi = gathered[:2], gathered[2]
        gu, gv = guv[0], guv[1]

        # 3. REPLAY on the committed state, in place
        _, winners, _ = stream_pass(state, gu, gv, **pass_kw)
        mask[torch.where(winners, gi, mask_len).long()] = True

        # 4. REQUEUE provisional-dead edges still free after the replay,
        # compacted to the front in stream order (a stable sort)
        requeue = dead_prov & (state[ends] == ACC).all(0)
        order = torch.argsort(requeue.to(torch.uint8), descending=True,
                              stable=True)[:cap]
        retry = torch.where(requeue[order], slab_uvi[:, order], -1)
        if cap_eff < cap:
            # FAULT: a truncated buffer drops the entries past its
            # capacity, counted as overflow
            retry[:, cap_eff:] = -1
        local = torch.stack([proposed, requeue, valid]).sum(
            1, dtype=torch.int32)
        replayed = torch.stack([(gu >= 0) & (gu != gv), winners]).sum(
            1, dtype=torch.int32)
        stats += torch.cat([
            local, (local[1:2] - cap_eff).clamp(min=0),
            torch.where(valid, local_conf, 0).sum(dtype=torch.int32)[None],
            replayed])
        return state, mask, retry, stats

    return one_round, round_bytes


def _run_rounds(one_round, carry, blocks: torch.Tensor, drain_rounds: int,
                block: int, device) -> tuple:
    """The dealt blocks [R, 3, block] in order, then ``drain_rounds``
    empty ones: a Python loop that never waits for the host."""
    for r in range(blocks.shape[0]):
        carry = one_round(carry, blocks[r])
    empty = torch.full((3, block), -1, dtype=torch.int32, device=device)
    for _ in range(drain_rounds):
        carry = one_round(carry, empty)
    return carry


def _aggregate_stats(stats: torch.Tensor, retry: torch.Tensor, group,
                     num_devices: int,
                     window_matches: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """After the drain: sum the per-rank counts and the undrained retry
    entries over ranks (one ``all_reduce``), then derive the reference's
    int32 [props, req, ovf, und, reads, l_loc, l_rep, s_rep, wins]: the
    reads are the valid local slots, the local loads two a valid slot and
    two a conflict, the replay's loads and stores two a replayed slot and
    two a winner (plus two a window-tier match, ``window_matches``,
    already summed over ranks). int32 wraps as the reference's does."""
    und = (retry[0] >= 0).sum(dtype=torch.int32)
    per_rank = torch.cat([stats[:_PER_RANK], und[None]])
    props, req, nvalid, ovf, nconf, und = _all_sum(
        per_rank, group, num_devices).unbind()
    nrepl, nwin = stats[_PER_RANK:].unbind()
    s_rep = 2 * nwin
    if window_matches is not None:
        s_rep = s_rep + 2 * window_matches
    return torch.stack([props, req, ovf, und, nvalid, 2 * nvalid + 2 * nconf,
                        2 * nrepl, s_rep, nwin])


def _check_ids(ids: torch.Tensor, n: int, where: str) -> None:
    """Every valid slot's ids in [0, n): the check the kernel's wrapper
    would make each round, made once (it waits for the card)."""
    if ids.numel() and int(ids.max()) >= n:  # host-sync: ok — once a run
        raise ValueError(f"{where}: vertex ids must lie below {n}")


def _normalised(u: torch.Tensor, v: torch.Tensor):
    """Invalid slots (``u < 0`` or ``u == v``) as (-1, -1), which the
    engine skips as it skips any invalid slot, and the kernel's id check
    admits."""
    valid = (u >= 0) & (u != v)
    return torch.where(valid, u, -1), torch.where(valid, v, -1)


# ------------------------------------------------------------ dispersed --
def _dispersed_run(edges: EdgeList, group, num_devices: int, rank: int,
                   block_size: int, vector_rounds: int, tile_size: int,
                   drain_rounds: int, faults, spec: StateSpec, backend: str,
                   device: torch.device):
    """One raw dispersed-block execution (paper §IV-C), no policy."""
    n, m = edges.num_vertices, edges.num_edges
    e = edges.to(device).canonical()
    ub, vb = dispersed_blocks(e, num_devices, block_size)  # [D, R, B]
    num_rounds = ub.shape[1]
    mask_len = num_devices * num_rounds * block_size
    u, v = _normalised(ub[rank], vb[rank])
    _check_ids(v, n, "distributed_skipper")
    # global stream index of (d, r, b) = (r * D + d) * B + b
    r_ids = torch.arange(num_rounds, dtype=torch.int32, device=device)
    b_ids = torch.arange(block_size, dtype=torch.int32, device=device)
    ib = (r_ids[:, None] * num_devices + rank) * block_size + b_ids[None, :]
    blocks = torch.stack([u, v, ib], dim=1)  # [R, 3, B]

    one_round, round_bytes = _make_round_fn(
        n=n, mask_len=mask_len, group=group, num_devices=num_devices,
        rank=rank, vector_rounds=vector_rounds, tile_size=tile_size,
        block=block_size, backend=backend, device=device, faults=faults)
    state = torch.full((n,), ACC, dtype=spec.at_rest_dtype, device=device)
    if faults is not None and faults.corrupt_state > 0.0:
        # FAULT: out-of-domain cells in the committed state: every edge on
        # them dies undecided
        state.masked_fill_(corruption_mask(faults, n, device), CORRUPT)
    mask = torch.zeros((mask_len + 1,), dtype=torch.bool, device=device)
    retry = torch.full((3, block_size), -1, dtype=torch.int32, device=device)
    stats = torch.zeros((len(_RAW),), dtype=torch.int32, device=device)
    state, mask, retry, stats = _run_rounds(
        one_round, (state, mask, retry, stats), blocks, drain_rounds,
        block_size, device)
    agg = _aggregate_stats(stats, retry, group, num_devices)
    gbytes = _i32(round_bytes * (num_rounds + drain_rounds))
    # the dealt stream keeps stream order: edge k sits at stream index k
    return _finalize(mask[:m], state, agg, gbytes)


# ------------------------------------------------------ locality-sharded --
def _sharded_run(device_schedule: DeviceSchedule, group, num_devices: int,
                 rank: int, vector_rounds: int, drain_rounds: int,
                 backend: str, faults, spec: StateSpec,
                 device: torch.device):
    """One locality-sharded execution and its epilogue, no policy.

    PHASE A (window tier, no communication): this rank's dealt rows
    through ``engine.window_tier_pass`` (the window-tier kernel on the
    card), so a row's result does not depend on the rank that ran it; one
    ``spec.combine_rows`` over the per-row states (disjoint rows; O(rows x
    window) bytes at the wire width) rebuilds the committed state on every
    rank. PHASE B (global tier): the protocol's rounds over the dealt
    boundary blocks against that state, gathering bare stream indices."""
    ds = device_schedule
    s = ds.schedule
    window, tile = s.window, s.tile_size
    num_rows, slots = s.num_rows, s.tiles_per_window * s.tile_size
    n_flat = s.num_windows * window
    mask_len = s.num_boundary_padded

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    # ---- PHASE A: the window tier, no collectives -----------------------
    u_rows, v_rows = put(ds.u_rows[rank]), put(ds.v_rows[rank])
    states, matched_w, conf_w = window_tier_pass(
        u_rows, v_rows, window=window, tiles_per_window=s.tiles_per_window,
        tile_size=tile, vector_rounds=vector_rounds, backend=backend,
        spec=spec)
    w_valid = u_rows >= 0
    if (faults is not None and faults.lose_shard is not None
            and rank == faults.lose_shard % num_devices):
        # FAULT: this rank's whole window tier (state rows AND matched
        # bits, kept consistent) vanishes before the combine; its
        # global-tier proposals are swallowed in the rounds
        states.zero_()
        matched_w.zero_()
    # the committed state: this rank's rows at their schedule rows
    # (disjoint across ranks), combined at the wire width, then placed at
    # their window ids (coalesced windows stay all-ACC)
    row_slot = ds.row_slot[rank]
    mine = np.flatnonzero(row_slot >= 0)
    rows_state = torch.zeros((num_rows, window), dtype=spec.wire_dtype,
                             device=device)
    rows_state[put(row_slot[mine]).long()] = states[put(mine).long()].to(
        spec.wire_dtype)
    spec.combine_rows(rows_state, group)
    flat = torch.zeros((s.num_windows, window), dtype=spec.wire_dtype,
                       device=device)
    flat[put(s.window_ids).long()] = rows_state
    flat = flat.reshape(n_flat).to(spec.at_rest_dtype)
    if faults is not None and faults.corrupt_state > 0.0:
        # FAULT: corrupt the assembled state (renumbered flat ids) before
        # the global tier reads it: skipper_match's injection site
        flat.masked_fill_(corruption_mask(faults, n_flat, device), CORRUPT)

    # ---- PHASE B: the global tier's rounds ------------------------------
    block = ds.block_size
    num_rounds = ds.num_rounds
    nvalid_w = w_valid.sum(dtype=torch.int32)
    nconf_w = torch.where(w_valid, conf_w.to(torch.int32), 0).sum(
        dtype=torch.int32)
    # the window tier's stores happen on each rank; the stores are
    # counted once (as the replay's), so they are summed over ranks here
    nmatch_w = _all_sum(
        torch.where(w_valid, matched_w.to(torch.int32), 0).sum(
            dtype=torch.int32),
        group, num_devices)
    z = torch.zeros((), dtype=torch.int32, device=device)
    stats = torch.stack([z, z, nvalid_w, z, nconf_w, z, z])
    # the PHASE A combine's payload: O(V) at the wire width, no topology
    gbytes = num_devices * num_rows * window * spec.wire_bytes
    if num_rounds > 0:
        lu, lv = _normalised(put(s.boundary_u), put(s.boundary_v))
        bu, bv = _normalised(put(ds.boundary_ub[rank]),
                             put(ds.boundary_vb[rank]))
        _check_ids(torch.cat([lu, lv, bu.reshape(-1), bv.reshape(-1)]),
                   n_flat, "distributed_skipper")
        blocks = torch.stack([bu, bv, put(ds.boundary_ib[rank])], dim=1)
        one_round, round_bytes = _make_round_fn(
            n=n_flat, mask_len=mask_len, group=group,
            num_devices=num_devices, rank=rank, vector_rounds=vector_rounds,
            tile_size=tile, block=block, backend=backend, device=device,
            edge_lookup=(lu, lv), faults=faults)
        mask0 = torch.zeros((mask_len + 1,), dtype=torch.bool, device=device)
        retry = torch.full((3, block), -1, dtype=torch.int32, device=device)
        flat, bmask, retry, stats = _run_rounds(
            one_round, (flat, mask0, retry, stats), blocks, drain_rounds,
            block, device)
        bmask = bmask[:mask_len]
        gbytes += round_bytes * (num_rounds + drain_rounds)
    else:
        bmask = torch.zeros((mask_len,), dtype=torch.bool, device=device)
        retry = torch.full((3, 1), -1, dtype=torch.int32, device=device)
    agg = _aggregate_stats(stats, retry, group, num_devices, nmatch_w)

    # ---- epilogue: decisions to stream order, state to original ids (the
    # [windowed ++ global ++ pad] slot layout skipper_match uses); every
    # rank's window-tier bits, gathered
    matched_out = torch.where(w_valid, matched_w, 0).to(torch.uint8)
    every = _all_gather(matched_out.reshape(1, -1), group, num_devices)
    every = every.reshape(-1, num_devices).T.reshape(-1, slots)
    slot_all = ds.row_slot.reshape(-1)
    real = np.flatnonzero(slot_all >= 0)
    dec_w = torch.zeros((num_rows, slots), dtype=torch.uint8, device=device)
    dec_w[put(slot_all[real]).long()] = every[put(real).long()]
    decisions = torch.cat([dec_w.reshape(-1), bmask.to(torch.uint8),
                           torch.zeros((1,), dtype=torch.uint8,
                                       device=device)])
    mask = decisions[put(s.stream_src).long()] > 0
    perm = (put(s.perm).long() if s.perm is not None
            else torch.arange(s.num_vertices, device=device))
    state = flat[perm].to(spec.at_rest_dtype)
    return _finalize(mask, state, agg, _i32(gbytes))


# ------------------------------------------------------------ policy ----
def _finalize(mask: torch.Tensor, state: torch.Tensor, agg: torch.Tensor,
              gbytes: int) -> Tuple[MatchResult, DistStats]:
    """Counters and stats from the aggregated vector (no policy:
    :func:`_apply_policy` raises, recovers or reports)."""
    props, req, ovf, und, reads, l_loc, l_rep, s_rep, wins = agg.unbind()
    one = torch.ones((), dtype=torch.int32, device=agg.device)
    counters = Counters(edge_reads=reads, state_loads=l_loc + l_rep,
                        state_stores=s_rep, rounds=one)
    dstats = DistStats(
        proposals=props, lost_proposals=props - wins, requeued=req,
        retry_overflow=ovf, undrained=und,
        gathered_bytes=torch.tensor(gbytes, dtype=torch.int32,
                                    device=agg.device))
    return MatchResult(match_mask=mask, state=state, counters=counters), dstats


def _effective_knobs(block_size: int, drain_rounds: int, faults):
    """The (retry capacity, drain rounds) a run actually gets once the
    plan has had its say: the ladder stops escalating a knob the plan
    pins."""
    cap = block_size
    if faults is not None and faults.truncate_retry is not None:
        cap = min(cap, faults.truncate_retry)
    dr = 0 if (faults is not None and faults.skip_drain) else drain_rounds
    return cap, dr


def _apply_policy(run, edges: Optional[EdgeList], *, on_fault: str,
                  verify: bool, faults, block_size: int, drain_rounds: int,
                  tile_size: int, vector_rounds: int, spec: StateSpec,
                  backend: str) -> Tuple[MatchResult, DistStats]:
    """The recovery ladder (DESIGN.md §11), shared by both schedules.

    ``run(block_size, drain_rounds)`` executes the protocol once. Under
    ``"raise"``: ``raise_if_bad()``. Under ``"report"``: fill
    ``residual_edges`` and ``corrupted_cells``. Under ``"recover"``: up to
    ``_MAX_ESCALATIONS`` re-runs regrowing the knob that tripped (retry
    capacity on overflow, drain rounds when undrained) unless the plan
    pins it, then the residual replay, which completes the matching.
    ``verify=True`` runs ``check_matching`` on the final mask. Every gate
    here waits for the card."""
    bs, dr = block_size, drain_rounds
    result, dstats = run(bs, dr)
    if on_fault == "raise":
        if not verify:
            dstats.raise_if_bad()
    elif on_fault == "recover":
        attempts = 0
        for _ in range(_MAX_ESCALATIONS):
            ovf, und = dstats._tripwires()  # the ladder's gate
            if ovf == 0 and und == 0:
                break
            nbs = bs * 2 if ovf > 0 else bs
            ndr = max(1, dr) * 2 if und > 0 else dr
            if _effective_knobs(nbs, ndr, faults) == _effective_knobs(
                    bs, dr, faults):
                break  # the plan pins the knob: straight to the replay
            bs, dr = nbs, ndr
            attempts += 1
            result, dstats = run(bs, dr)
        mask, state, residual, recovered, corrupted = residual_replay(
            edges, result.match_mask, result.state, tile_size=tile_size,
            vector_rounds=vector_rounds, spec=spec, backend=backend)
        both = torch.stack([residual, corrupted])
        res_i, cor_i = both.tolist()  # host-sync: ok — the ladder's gate
        if res_i > 0 or cor_i > 0:
            attempts += 1  # the replay rung did work
        result = MatchResult(match_mask=mask, state=state,
                             counters=result.counters)
        dstats = dataclasses.replace(
            dstats,
            recovery_attempts=torch.tensor(attempts, dtype=torch.int32,
                                           device=residual.device),
            residual_edges=residual, recovered_matches=recovered,
            corrupted_cells=corrupted)

    if on_fault == "report" or (verify and on_fault == "raise"):
        residual, corrupted = detect_residual(edges, result.match_mask,
                                              result.state)
        dstats = dataclasses.replace(dstats, residual_edges=residual,
                                     corrupted_cells=corrupted)

    if verify:
        chk = check_matching(edges.to(result.match_mask.device),
                             result.match_mask)
        dev = result.match_mask.device
        checks = torch.stack([
            chk["valid"].to(torch.int32), chk["maximal"].to(torch.int32),
            torch.as_tensor(dstats.residual_edges, device=dev),
            torch.as_tensor(dstats.corrupted_cells, device=dev)])
        ok_v, ok_m, res_i, cor_i = (
            x != 0 if i < 2 else x
            for i, x in enumerate(checks.tolist()))  # host-sync: ok — verify
        if on_fault == "recover" and not (ok_v and ok_m):
            raise RuntimeError(
                "verify=True after on_fault='recover': recovered matching "
                f"failed validation (valid={ok_v}, "
                f"maximal={ok_m}) — this is a bug in the recovery "
                "ladder, please report it")
        if on_fault == "raise" and not (ok_v and ok_m and res_i == 0
                                        and cor_i == 0):
            raise RuntimeError(
                "verify=True: matching failed validation "
                f"(valid={ok_v}, maximal={ok_m}, "
                f"residual_edges={res_i}, corrupted_cells={cor_i}) — run "
                "on_fault='recover' to complete it or 'report' to inspect")
    return result, dstats


def distributed_skipper(
    edges: Optional[EdgeList] = None,
    group=None,
    block_size: int = 512,
    vector_rounds: int = 1,
    tile_size: int = 256,
    drain_rounds: int = 4,
    reorder: str = "none",
    window: Optional[int] = None,
    schedule: Optional[WindowSchedule] = None,
    device_schedule: Optional[DeviceSchedule] = None,
    backend: Optional[str] = None,
    on_fault: str = "raise",
    verify: bool = False,
    faults: Optional[FaultPlan] = None,
    spec: Optional[StateSpec] = None,
    device=None,
) -> Tuple[MatchResult, DistStats]:
    """Run Skipper across the ranks of ``group`` (module docstring).

    Every rank calls it with the same arguments and gets the same result.
    ``group=None`` with no process group is one rank. ``device=None``
    means the card (each rank's current CUDA device) and raises without
    one; give ``device="cpu"`` with gloo. ``backend``: ``"cuda"`` (the
    default on a CUDA device) runs the window tier and every slab pass
    through the kernels, ``"torch"`` their plain versions.

    With ``reorder="none"`` and no ``window`` or schedule the raw stream is
    dealt in dispersed blocks; otherwise the locality-sharded schedule
    runs (a prebuilt ``schedule`` / ``device_schedule`` skips the host
    precompute). Results are in the original stream order and vertex ids.

    ``on_fault``: ``"raise"`` (default) raises ``RuntimeError`` if a
    must-be-zero invariant tripped; ``"report"`` never raises and fills
    the ``DistStats`` damage fields (needs ``edges``); ``"recover"`` runs
    the ladder (at most ``_MAX_ESCALATIONS`` re-runs, then the residual
    replay), whose result is valid and maximal on the uncorrupted graph
    (needs ``edges``). ``verify=True`` checks the final mask. ``faults``
    injects a :class:`FaultPlan`; an inactive plan is the clean path.
    ``spec`` sets the state widths (the committed state at
    ``spec.at_rest``, the window tier at ``spec.vmem``, the state
    assembly at ``spec.wire``).
    """
    if on_fault not in ("raise", "recover", "report"):
        raise ValueError("on_fault must be 'raise', 'recover' or "
                         f"'report', got {on_fault!r}")
    if (verify or on_fault in ("recover", "report")) and edges is None:
        raise ValueError(
            "on_fault='recover'/'report' and verify=True need the original "
            "edge list — pass edges even when a prebuilt schedule is given")
    group, num_devices, rank = _ranks(group)
    dev = resolve_device(device, "cuda", "distributed_skipper")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = resolve_backend(backend, dev)
    spec = resolve_spec(spec)
    if faults is not None and not faults.active:
        faults = None  # all sites off: the clean path
    drain_eff = 0 if (faults is not None and faults.skip_drain) else None
    policy = dict(on_fault=on_fault, verify=verify, faults=faults,
                  drain_rounds=drain_rounds, tile_size=tile_size,
                  vector_rounds=vector_rounds, spec=spec, backend=backend)

    sharded = (reorder != "none" or window is not None
               or schedule is not None or device_schedule is not None)
    if not sharded:
        if edges is None:
            raise ValueError("the dispersed schedule needs an edge list")

        def run_dispersed(bs, dr):
            return _dispersed_run(
                edges, group, num_devices, rank, bs, vector_rounds,
                tile_size, dr if drain_eff is None else drain_eff, faults,
                spec, backend, dev)

        return _apply_policy(run_dispersed, edges, block_size=block_size,
                             **policy)

    if device_schedule is None:
        if schedule is None and edges is None:
            raise ValueError("need edges or a prebuilt (device) schedule")
        device_schedule = locality_device_schedule(
            edges, num_devices, block_size, window=window,
            tile_size=tile_size, reorder=reorder, schedule=schedule)
    if device_schedule.num_devices != num_devices:
        raise ValueError(
            f"device_schedule was partitioned for "
            f"{device_schedule.num_devices} ranks, the group has "
            f"{num_devices}")
    ds0, bs0 = device_schedule, device_schedule.block_size

    def run_sharded(bs, dr):
        # an escalated retry capacity is an escalated global-tier block:
        # re-deal the same schedule (the window tier's deal is unchanged)
        ds = ds0 if bs == bs0 else partition_schedule(
            ds0.schedule, num_devices, bs)
        return _sharded_run(ds, group, num_devices, rank, vector_rounds,
                            dr if drain_eff is None else drain_eff, backend,
                            faults, spec, dev)

    return _apply_policy(run_sharded, edges, block_size=bs0, **policy)
