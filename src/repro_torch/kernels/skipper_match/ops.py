"""Entry points of the single-pass matcher (port of
``repro.kernels.skipper_match.ops``).

``skipper_match_window`` — one window-local edge stream against a
    caller-given state (the window-tier kernel launched with one row).
``skipper_match``        — the full-graph matcher: a host numpy precompute
    (``graphs/windows.build_window_schedule``, optionally behind a
    ``reorder=`` renumbering), then the window tier (one block per dense
    window row), the global tier (one block walking the block-pair grouped
    tiles in schedule order), and a gather of the decisions back to stream
    order and original vertex ids, with the ``Counters``.

Device and backend: ``device=None`` means ``"cuda"`` and raises
``RuntimeError`` when no CUDA device exists; nothing falls back to the CPU.
``backend="cuda"`` (the default on a CUDA device) launches the hand-written
kernels; ``backend="torch"`` runs their plain versions (``ref.py``) on any
device, and is the only backend on the CPU (``device.resolve_backend``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import engine
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.core.types import Counters, MatchResult
from repro_torch.core.validate import (
    check_matching,
    check_state_domain,
    first_offender,
)
from repro_torch.device import resolve_backend, resolve_device
from repro_torch.graphs.types import EdgeList
from repro_torch.graphs.windows import WindowSchedule, build_window_schedule
from repro_torch.kernels.skipper_match import kernel, ref

#: each CUDA device's copy stream for the schedule, made at its first call
_COPY_STREAMS: Dict[int, torch.cuda.Stream] = {}


def skipper_match_window(
    u: torch.Tensor,
    v: torch.Tensor,
    state0: torch.Tensor,
    tile_size: int = 256,
    vector_rounds: int = 1,
    fallback: bool = True,
    backend: Optional[str] = None,
    spec: Optional[StateSpec] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match a window-local edge stream on ``device`` (``None``: the card;
    the tensors are moved there).

    u, v: int32[M] window-local ids, -1 padding; state0: [W] (coerced to
    ``spec.vmem``). Returns ``(state, matched, conflicts)`` in spec.vmem /
    spec.counter widths, matched/conflicts of length M, on ``device``."""
    dev = resolve_device(device, "cuda", "skipper_match_window")
    backend = resolve_backend(backend, dev)
    spec = resolve_spec(spec)
    u, v, state0 = (t.to(dev) for t in (u, v, state0))
    m = u.shape[0]
    pad = (-m) % tile_size
    if pad:
        fill = torch.full((pad,), -1, dtype=torch.int32, device=u.device)
        u = torch.cat([u, fill])
        v = torch.cat([v, fill])
    state_in = state0.to(spec.vmem_dtype).reshape(1, -1).contiguous()
    u_row = u.to(torch.int32).reshape(1, -1).contiguous()
    v_row = v.to(torch.int32).reshape(1, -1).contiguous()
    if backend == "cuda":
        state, matched, conflicts = kernel.window_tier(
            u_row, v_row, state_in, tile_size=tile_size,
            vector_rounds=vector_rounds, fallback=fallback, spec=spec)
    else:
        state, matched, conflicts = ref.ref_window_tier(
            u_row, v_row, state_in, tile_size=tile_size,
            vector_rounds=vector_rounds, fallback=fallback, spec=spec)
    return state[0], matched[0, :m], conflicts[0, :m]


def _copy_stream(dev: torch.device) -> torch.cuda.Stream:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _COPY_STREAMS.get(index)
    if stream is None:
        stream = _COPY_STREAMS[index] = torch.cuda.Stream(device=index)
    return stream


def _stage(host: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``host`` on the CUDA device ``dev``, queued without a wait for the
    card: the host copies it into pinned memory (torch's copy, on its
    intra-op threads), then a DMA on the device's copy stream moves it, and
    the current stream waits for that DMA before its next work. The caller's
    memory is read before the return; the DMA reads only the pinned block,
    which torch's caching host allocator keeps for later calls and hands out
    again only once the DMA has landed. The device block comes from the copy
    stream's pool and is reused only after the current stream's work queued
    before its release (``record_stream``)."""
    compute, copy = torch.cuda.current_stream(dev), _copy_stream(dev)
    pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    pinned.copy_(host)
    with torch.cuda.stream(copy):
        out = torch.empty(host.shape, dtype=host.dtype, device=dev)
        out.copy_(pinned, non_blocking=True)
    compute.wait_stream(copy)
    out.record_stream(compute)
    tracing.count("h2d_staged_bytes", out.nbytes)
    return out


@tracing.spanned("skipper_match")
def skipper_match(
    edges: Optional[EdgeList] = None,
    window: int = 2048,
    tile_size: int = 256,
    vector_rounds: int = 1,
    backend: Optional[str] = None,
    schedule: Optional[WindowSchedule] = None,
    dispersed: bool = True,
    reorder: str = "none",
    with_conflicts: bool = False,
    conflict_method: str = "auto",
    faults=None,
    on_fault: str = "raise",
    verify: bool = False,
    spec: Optional[StateSpec] = None,
    device=None,
) -> Union[MatchResult, Tuple]:
    """Full-graph matcher: window tier, then global tier, on ``device``.

    Pass ``schedule`` (from ``build_window_schedule``) to skip the host
    precompute; ``window`` / ``tile_size`` / ``dispersed`` / ``reorder``
    are then taken from it. Results — mask, conflicts and state — are in
    the original edge-stream order and vertex ids. ``conflict_method``
    reaches the plain global tier's ``engine.tile_pass`` and never changes
    the output. ``spec`` picks the state and counter widths
    (``StateSpec.u8()`` by default; ``legacy_i32()`` is bit-identical).

    Failure handling (DESIGN.md §11): ``faults=`` takes a
    :class:`~repro_torch.core.faults.FaultPlan` (an inactive plan is the
    clean path) and injects the single-device analogues of the
    distributed sites at the same stream positions and state cells:
    ``lose_shard`` loses one window row's state and matched bits after the
    window tier, ``corrupt_state`` writes ``CORRUPT`` into the assembled
    state, ``drop_proposals`` drops global-tier slots before the global
    tier. ``on_fault``:

    * ``"raise"`` (default): return the result as it is; with
      ``verify=True`` raise ``RuntimeError``, naming the first offending
      edge, unless it is a valid maximal matching with a clean state.
    * ``"report"``: append a :class:`~repro_torch.core.faults.RecoveryReport`
      (detection only). Needs ``edges``.
    * ``"recover"``: complete the matching by the residual replay
      (``faults.residual_replay``, through the global-tier kernel on the
      card); the result is valid and maximal on the uncorrupted graph, and
      the ``Counters`` still describe the faulted run. Appends the
      report. Needs ``edges``.

    The report's reads and ``verify`` wait for the card.

    Tracing (``repro_torch/tracing.py``): the call is the span
    ``skipper_match``, its steps the spans ``skipper_match.copy`` (each
    ``put`` of a schedule array), ``.window_tier``, ``.global_tier``,
    ``.gather`` (to stream order and original ids) and ``.counters``; the
    bytes it moves to the card add to ``h2d_bytes``, those of them staged
    through pinned memory and the copy stream (every schedule array, on a
    CUDA device) to ``h2d_staged_bytes``, and while a profiler
    records each tier adds its edges and the edges its exact fallback
    decides to ``skipper_match.<tier>.edges`` / ``.fallback_edges``.

    Returns ``result`` [, ``conflicts`` int32[|E|] if ``with_conflicts``]
    [, ``report`` if ``on_fault != "raise"``].
    """
    from repro_torch.core import faults as flt

    if on_fault not in ("raise", "recover", "report"):
        raise ValueError(
            f"on_fault must be 'raise', 'recover' or 'report', got {on_fault!r}"
        )
    if (verify or on_fault in ("recover", "report")) and edges is None:
        raise ValueError(
            "verify=True (and on_fault='recover'/'report') needs the "
            "original edge list — pass edges even when a prebuilt schedule "
            "is given")
    if faults is not None and not faults.active:
        faults = None  # all sites off: the clean path
    dev = resolve_device(device, "cuda", "skipper_match")
    backend = resolve_backend(backend, dev)
    spec = resolve_spec(spec)
    if schedule is None:
        if edges is None:
            raise ValueError("need either edges or a prebuilt schedule")
        schedule = build_window_schedule(
            edges, window, tile_size, dispersed, reorder=reorder
        )

    def put(a: np.ndarray) -> torch.Tensor:
        with tracing.span("skipper_match.copy"):
            t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
            if dev.type == "cuda":
                t = _stage(t, dev)
                tracing.count("h2d_bytes", t.nbytes)
        return t

    s = schedule
    window, tile_size = s.window, s.tile_size
    m = s.num_edges
    nb_tiles = s.num_boundary_tiles

    # window tier: dense rows, each from an all-ACC window-local state
    with tracing.span("skipper_match.window_tier"):
        state2, matched2, conf2 = engine.window_tier_pass(
            put(s.u_tiles), put(s.v_tiles), window=window,
            tiles_per_window=s.tiles_per_window, tile_size=tile_size,
            vector_rounds=vector_rounds, backend=backend, spec=spec,
        )
        engine.count_fallback("skipper_match.window_tier", conf2,
                              vector_rounds, s.num_windowed)
        if faults is not None and faults.lose_shard is not None and s.num_rows:
            # FAULT: one window row's tier contribution (state AND matched
            # bits) vanishes
            lost_row = faults.lose_shard % s.num_rows
            state2[lost_row] = 0
            matched2[lost_row] = 0
        # rows hold only the dense windows; coalesced windows stay all-ACC
        flat = torch.zeros((s.num_windows, window), dtype=spec.vmem_dtype,
                           device=dev)
        flat[put(s.window_ids).long()] = state2
        if faults is not None and faults.corrupt_state > 0.0:
            # FAULT: out-of-domain cells in the assembled state (renumbered
            # flat ids), as in the locality-sharded distributed run
            hit = flt.corruption_mask(faults, s.num_windows * window, dev)
            flat.view(-1).masked_fill_(hit, flt.CORRUPT)
        dec = [matched2.reshape(-1)]
        cfs = [conf2.reshape(-1)]

    cdt = spec.counter_dtype
    if nb_tiles:
        with tracing.span("skipper_match.global_tier"):
            bu, bv = put(s.boundary_ulocal), put(s.boundary_vlocal)
            if faults is not None and faults.drop_proposals > 0.0:
                # FAULT: dropped global-tier slots are never decided (the
                # mask is keyed by global-tier stream position: the
                # distributed gather-drop's victims)
                drop = flt.proposal_drop_mask(faults, s.num_boundary_padded,
                                              dev)
                bu = bu.masked_fill(drop, -1)
                bv = bv.masked_fill(drop, -1)
            args = (flat, put(s.boundary_blk_u), put(s.boundary_blk_v),
                    bu.reshape(nb_tiles, tile_size),
                    bv.reshape(nb_tiles, tile_size))
            if backend == "cuda":
                bmt, bcf = kernel.boundary_tier(
                    *args, vector_rounds=vector_rounds, spec=spec)
            else:
                bmt, bcf = ref.ref_boundary_pass(
                    *args, vector_rounds=vector_rounds,
                    conflict_method=conflict_method, spec=spec)
            engine.count_fallback("skipper_match.global_tier", bcf,
                                  vector_rounds, s.num_valid - s.num_windowed)
            dec.append(bmt.reshape(-1))
            cfs.append(bcf.reshape(-1))
    else:  # no global tier: it decides no edge
        engine.count_fallback("skipper_match.global_tier", None,
                              vector_rounds, 0)
    with tracing.span("skipper_match.gather"):
        zero = torch.zeros((1,), dtype=cdt, device=dev)
        # slot-order decisions back to stream order: [windowed ++ global ++
        # pad]
        src = put(s.stream_src).long()
        mask = torch.cat(dec + [zero])[src] > 0
        conf = torch.cat(cfs + [zero])[src].to(torch.int32)

    def i32(x):
        if dev.type == "cuda":
            tracing.count("h2d_bytes", 4)
        return torch.tensor(x, dtype=torch.int32, device=dev)

    with tracing.span("skipper_match.counters"):
        nmatch = mask.sum(dtype=torch.int32)
        nconf = conf.sum(dtype=torch.int32)
        counters = Counters(
            edge_reads=i32(m),
            state_loads=i32(2 * m) + 2 * nconf,
            state_stores=2 * nmatch,
            rounds=i32(1),
        )
    with tracing.span("skipper_match.gather"):
        # back to ORIGINAL vertex ids: vertex i lives at renumbered slot
        # perm[i]
        state_flat = flat.reshape(-1)
        if s.perm is not None:
            state_flat = state_flat[put(s.perm).long()]
        else:
            state_flat = state_flat[: s.num_vertices]
        result = MatchResult(match_mask=mask,
                             state=state_flat.to(spec.at_rest_dtype),
                             counters=counters)

    report = None
    if on_fault == "recover":
        rmask, rstate, residual, recovered, corrupted = flt.residual_replay(
            edges, result.match_mask, result.state, tile_size=tile_size,
            vector_rounds=vector_rounds, spec=spec, backend=backend)
        counts = torch.stack([residual, recovered, corrupted])
        res_i, rec_i, cor_i = counts.tolist()  # host-sync: ok — the report
        result = MatchResult(match_mask=rmask, state=rstate,
                             counters=counters)
        report = flt.RecoveryReport(
            recovery_attempts=1 if (res_i or cor_i) else 0,
            residual_edges=res_i, recovered_matches=rec_i,
            corrupted_cells=cor_i)
    elif on_fault == "report":
        residual, corrupted = flt.detect_residual(
            edges, result.match_mask, result.state)
        counts = torch.stack([residual, corrupted])
        res_i, cor_i = counts.tolist()  # host-sync: ok — the fault report
        report = flt.RecoveryReport(residual_edges=res_i,
                                    corrupted_cells=cor_i)
    if verify and on_fault != "report":
        _verify(edges, result, strict=on_fault == "raise")

    out = (result,)
    if with_conflicts:
        out = out + (conf,)
    if on_fault != "raise":
        out = out + (report,)
    return out if len(out) > 1 else result


def _verify(edges: EdgeList, result: MatchResult,
            strict: bool = True) -> None:
    """``verify=True``: under ``strict`` (``on_fault="raise"``) the result
    must be a valid maximal matching with a clean state domain; after
    ``"recover"`` valid and maximal (the ladder's own check); after
    ``"report"`` nothing is required."""
    chk = check_matching(edges, result.match_mask)
    dom = check_state_domain(result.state)
    ok_v, ok_m, clean = (bool(x) for x in  # host-sync: ok — verify=True
                         (chk["valid"], chk["maximal"], dom["clean"]))
    if not strict:
        if not (ok_v and ok_m):
            raise RuntimeError(
                "verify=True after on_fault='recover': recovered matching "
                f"failed validation (valid={ok_v}, maximal={ok_m}) — this "
                "is a bug in the recovery ladder, please report it")
        return
    if not (ok_v and ok_m and clean):
        raise RuntimeError(
            "verify=True: matching failed validation "
            f"(valid={ok_v}, maximal={ok_m}, "
            f"out_of_domain={int(dom['out_of_domain'])}, "
            f"rsvd_leaked={int(dom['rsvd_leaked'])}) — "
            + first_offender(edges, result.match_mask))
