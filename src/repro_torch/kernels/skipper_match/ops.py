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
device, and is the only backend on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.core.types import Counters, MatchResult
from repro_torch.core.validate import (
    check_matching,
    check_state_domain,
    first_offender,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.types import EdgeList
from repro_torch.graphs.windows import WindowSchedule, build_window_schedule
from repro_torch.kernels.skipper_match import kernel, ref

BACKENDS = ("cuda", "torch")


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """``None`` -> ``"cuda"`` on a CUDA device, ``"torch"`` elsewhere."""
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' launches CUDA kernels; got {device} tensors "
            "(use backend='torch' on the CPU)")
    return backend


def skipper_match_window(
    u: torch.Tensor,
    v: torch.Tensor,
    state0: torch.Tensor,
    tile_size: int = 256,
    vector_rounds: int = 1,
    fallback: bool = True,
    backend: Optional[str] = None,
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match a window-local edge stream on the tensors' device.

    u, v: int32[M] window-local ids, -1 padding; state0: [W] (coerced to
    ``spec.vmem``). Returns ``(state, matched, conflicts)`` in spec.vmem /
    spec.counter widths, matched/conflicts of length M."""
    spec = resolve_spec(spec)
    backend = resolve_backend(backend, u.device)
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

    ``verify=True`` checks that the result is a valid maximal matching with
    a clean state domain and raises ``RuntimeError`` naming the first
    offending edge otherwise. Fault injection (``faults=``,
    ``on_fault="recover"/"report"``) is not ported yet.

    Returns ``result`` [, ``conflicts`` int32[|E|] if ``with_conflicts``].
    """
    if on_fault not in ("raise", "recover", "report"):
        raise ValueError(
            f"on_fault must be 'raise', 'recover' or 'report', got {on_fault!r}"
        )
    if faults is not None or on_fault != "raise":
        raise NotImplementedError(
            "fault injection and on_fault='recover'/'report' are not ported "
            "yet (ROADMAP queue 1, item 9)")
    if verify and edges is None:
        raise ValueError(
            "verify=True needs the original edge list — pass edges even "
            "when a prebuilt schedule is given")
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
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    s = schedule
    window, tile_size = s.window, s.tile_size
    m = s.num_edges
    nb_tiles = s.num_boundary_tiles

    # window tier: dense rows, each from an all-ACC window-local state
    state2, matched2, conf2 = engine.window_tier_pass(
        put(s.u_tiles), put(s.v_tiles), window=window,
        tiles_per_window=s.tiles_per_window, tile_size=tile_size,
        vector_rounds=vector_rounds, backend=backend, spec=spec,
    )
    # rows hold only the dense windows; coalesced windows stay all-ACC
    flat = torch.zeros((s.num_windows, window), dtype=spec.vmem_dtype,
                       device=dev)
    flat[put(s.window_ids).long()] = state2

    cdt = spec.counter_dtype
    dec = [matched2.reshape(-1)]
    cfs = [conf2.reshape(-1)]
    if nb_tiles:
        args = (flat, put(s.boundary_blk_u), put(s.boundary_blk_v),
                put(s.boundary_ulocal).reshape(nb_tiles, tile_size),
                put(s.boundary_vlocal).reshape(nb_tiles, tile_size))
        if backend == "cuda":
            bmt, bcf = kernel.boundary_tier(
                *args, vector_rounds=vector_rounds, spec=spec)
        else:
            bmt, bcf = ref.ref_boundary_pass(
                *args, vector_rounds=vector_rounds,
                conflict_method=conflict_method, spec=spec)
        dec.append(bmt.reshape(-1))
        cfs.append(bcf.reshape(-1))
    zero = torch.zeros((1,), dtype=cdt, device=dev)
    # slot-order decisions back to stream order: [windowed ++ global ++ pad]
    src = put(s.stream_src).long()
    mask = torch.cat(dec + [zero])[src] > 0
    conf = torch.cat(cfs + [zero])[src].to(torch.int32)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    nmatch = mask.sum(dtype=torch.int32)
    nconf = conf.sum(dtype=torch.int32)
    counters = Counters(
        edge_reads=i32(m),
        state_loads=i32(2 * m) + 2 * nconf,
        state_stores=2 * nmatch,
        rounds=i32(1),
    )
    # back to ORIGINAL vertex ids: vertex i lives at renumbered slot perm[i]
    state_flat = flat.reshape(-1)
    if s.perm is not None:
        state_flat = state_flat[put(s.perm).long()]
    else:
        state_flat = state_flat[: s.num_vertices]
    result = MatchResult(match_mask=mask,
                         state=state_flat.to(spec.at_rest_dtype),
                         counters=counters)
    if verify:
        _verify(edges, result)
    return (result, conf) if with_conflicts else result


def _verify(edges: EdgeList, result: MatchResult) -> None:
    chk = check_matching(edges, result.match_mask)
    dom = check_state_domain(result.state)
    ok_v, ok_m, clean = (bool(x) for x in
                         (chk["valid"], chk["maximal"], dom["clean"]))
    if not (ok_v and ok_m and clean):
        raise RuntimeError(
            "verify=True: matching failed validation "
            f"(valid={ok_v}, maximal={ok_m}, "
            f"out_of_domain={int(dom['out_of_domain'])}, "
            f"rsvd_leaked={int(dom['rsvd_leaked'])}) — "
            + first_offender(edges, result.match_mask))
