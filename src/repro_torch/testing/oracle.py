"""Differential conformance: pin production matchings as APRAM traces
(port of ``repro.testing.oracle``).

The bridge theorem (DESIGN.md §13): a mask over a canonical edge stream is
a *reachable trace* of the APRAM reservation protocol **iff** it is a
valid maximal matching of that stream — and the witness is executable.
:func:`witness_schedule` orders the matched events first (in stream
order), then everything else; running that schedule through the *checked*
step-level model must reproduce the mask decision-for-decision:

* if the mask double-books a vertex, the second adjacent "matched" event
  finds a non-ACC cell and dies → mismatch (and the model's own
  ``no_double_match`` check fires);
* if the mask is non-maximal, some free edge with both endpoints
  uncovered comes up in the tail and the model commits it → mismatch.

So :func:`pin_trace` doesn't *trust* the theorem — it executes the
witness under full per-step invariant checking and compares. The port's
entry points (``skipper``, ``skipper_match`` on each backend of the
device, ``sgmm``, ``bmatch_assign`` via :func:`bipartite_stream`) are
``distributed_skipper``, the chaos-recovered ``skipper_match``) are
pinned this way; :func:`pin_entry_points` bundles the matrix.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.testing.apram import ApramResult, run_schedule


class ConformanceError(AssertionError):
    """A production mask is not a reachable APRAM trace.

    ``first_mismatch`` is the first stream index where the model's
    decision differs from the production mask (-1 when the failure came
    from the model's own invariant machinery instead)."""

    def __init__(self, message: str, *, first_mismatch: int = -1):
        super().__init__(message)
        self.first_mismatch = first_mismatch


def _host(a, dtype) -> np.ndarray:
    """An array or a tensor on any device as a host array."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()  # host-sync: ok — the model runs on the host
    return np.asarray(a, dtype)


def witness_schedule(edges, mask) -> np.ndarray:
    """The executable witness: matched events first (stream order), then
    the rest (stream order). For the true protocol this is the schedule
    under which a valid maximal mask reproduces itself exactly."""
    mask = _host(mask, bool)
    idx = np.arange(mask.shape[0], dtype=np.int64)
    return np.concatenate([idx[mask], idx[~mask]])


def pin_trace(edges, mask, *, label: str = "") -> ApramResult:
    """Assert ``mask`` is a reachable APRAM trace of ``edges``.

    Runs the matched-first witness schedule through the fully-checked
    model (``strict=True`` — any protocol invariant failing raises
    :class:`~repro_torch.testing.apram.ApramViolation` from underneath)
    and then requires the model's decisions to equal ``mask`` bit for bit.

    Args:
        edges: ``EdgeList`` or ``(u, v, num_vertices)`` tuple — the SAME
            stream (order included) the production matcher consumed.
        mask: bool[m] production match mask (an array, or a tensor on any
            device).
        label: prefixed to failure messages (name the entry point).

    Returns:
        The witness :class:`~repro_torch.testing.apram.ApramResult`.
    """
    mask = _host(mask, bool)
    result = run_schedule(edges, witness_schedule(edges, mask), strict=True)
    if not np.array_equal(result.matched, mask):
        k = int(np.flatnonzero(result.matched != mask)[0])
        who = f"{label}: " if label else ""
        raise ConformanceError(
            f"{who}mask is not a reachable APRAM trace: first divergence "
            f"at stream index {k} — edge ({result.u[k]}, {result.v[k]}) is "
            f"{'matched' if mask[k] else 'unmatched'} in the production "
            f"mask but the witness schedule "
            f"{'matched' if result.matched[k] else 'killed'} it "
            f"({'mask double-books a vertex' if mask[k] else 'mask is not maximal'})",
            first_mismatch=k,
        )
    return result


def bipartite_stream(
    token_ids, expert_ids, *, num_tokens: int, num_experts: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Map a b-matching candidate stream to a plain graph stream.

    At ``token_budget=1`` / ``expert_capacity=1`` the capacitated router
    IS unit matching on the bipartite graph with tokens at ids
    ``[0, num_tokens)`` and experts at ``num_tokens + expert_id`` — so
    ``bmatch_assign``'s accept mask can be pinned with :func:`pin_trace`
    on the stream this returns. Invalid candidates (``token_id < 0``)
    map to ``u = v = -1`` (invalid under the model's predicate)."""
    tok = _host(token_ids, np.int64)
    exp = _host(expert_ids, np.int64)
    bad = tok < 0
    u = np.where(bad, -1, tok)
    v = np.where(bad, -1, num_tokens + exp)
    return u, v, int(num_tokens) + int(num_experts)


def _spec_tag(spec) -> str:
    """The short name of a state spec in :func:`pin_entry_points`' keys."""
    from repro_torch.core.statespec import StateSpec

    if spec == StateSpec.u8():
        return "u8"
    if spec == StateSpec.legacy_i32():
        return "legacy_i32"
    return f"{spec.vmem}-{spec.combine}"


def pin_entry_points(
    edges,
    *,
    specs: Optional[Sequence] = None,
    window: int = 64,
    tile_size: int = 32,
    device=None,
    include_distributed: bool = True,
    include_chaos: bool = True,
) -> Dict[str, ApramResult]:
    """Pin the port's entry points on one edge list, on ``device``
    (``None``: the card).

    At every state width in ``specs`` (default: ``StateSpec.u8()`` and
    ``StateSpec.legacy_i32()``) it runs ``skipper``, ``skipper_match``
    with the plain backend (``"torch"``) and, on a CUDA device, with the
    kernels (``"cuda"``), and ``bmatch_assign`` at budget and capacity 1
    on the edges read as a token-expert stream (token ``u``, expert ``v``,
    pinned through :func:`bipartite_stream`); ``sgmm``, which has no state
    width, once. As the reference's rows: ``include_distributed`` adds
    ``distributed_skipper`` (one rank, ``block_size=tile_size``, the
    dispersed schedule) and ``include_chaos`` ``skipper_match`` under
    ``FaultPlan(seed=7, drop_proposals=0.25, corrupt_state=0.05)`` with
    ``on_fault="recover"``, both on the device's default backend (the
    kernels on the card). Each mask is :func:`pin_trace`-d.

    Returns ``{"<entry>@<spec>": ApramResult}`` (``"sgmm"`` alone); raises
    :class:`ConformanceError` / ``ApramViolation`` on the first failure.
    """
    from repro_torch.core.bipartite import bmatch_assign
    from repro_torch.core.distributed import distributed_skipper
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.sgmm import sgmm
    from repro_torch.core.skipper import skipper
    from repro_torch.core.statespec import StateSpec
    from repro_torch.device import resolve_device
    from repro_torch.kernels.skipper_match.ops import skipper_match

    dev = resolve_device(device, "cuda", "pin_entry_points")
    if specs is None:
        specs = (StateSpec.u8(), StateSpec.legacy_i32())
    backends = ("torch", "cuda") if dev.type == "cuda" else ("torch",)
    n = edges.num_vertices
    e = edges.to(dev).canonical()
    ok = (e.u >= 0) & (e.u != e.v)
    tok = torch.where(ok, e.u, -1)
    exp = torch.where(ok, e.v, 0)
    stream = bipartite_stream(tok, exp, num_tokens=n, num_experts=n)

    out: Dict[str, ApramResult] = {}

    def pin(name, mask, trace_edges=edges):
        out[name] = pin_trace(trace_edges, mask, label=name)

    for spec in specs:
        tag = _spec_tag(spec)
        res, _ = skipper(edges, tile_size=tile_size, spec=spec, device=dev)
        pin(f"skipper@{tag}", res.match_mask)
        for backend in backends:
            res = skipper_match(edges, window=window, tile_size=tile_size,
                                backend=backend, spec=spec, device=dev)
            pin(f"skipper_match_{backend}@{tag}", res.match_mask)
        accept = bmatch_assign(tok, exp, num_tokens=n, num_experts=n,
                               token_budget=1, expert_capacity=1,
                               tile_size=tile_size, spec=spec)
        pin(f"bmatch@{tag}", accept, stream)
        if include_distributed:
            res, _stats = distributed_skipper(
                edges, block_size=tile_size, tile_size=tile_size, spec=spec,
                device=dev)
            pin(f"distributed@{tag}", res.match_mask)
        if include_chaos:
            plan = FaultPlan(seed=7, drop_proposals=0.25, corrupt_state=0.05)
            res, _report = skipper_match(
                edges, window=window, tile_size=tile_size, faults=plan,
                on_fault="recover", spec=spec, device=dev)
            pin(f"chaos_recover@{tag}", res.match_mask)
    pin("sgmm", sgmm(edges).match_mask)
    return out
