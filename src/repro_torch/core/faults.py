"""Fault injection and the recovery ladder's last rung (port of
``repro.core.faults``; DESIGN.md §11).

Skipper's guarantee, every edge processed once and decided for good, is
what a distributed run can silently lose: a full retry buffer or an
undrained queue drops edges, a lost shard drops a window's decisions, a
corrupted state byte turns live vertices into ones no edge can match.

**Injection** (:class:`FaultPlan`): a seeded, deterministic, frozen plan of
which sites fire at what rate. An inactive plan is the clean path:
``skipper_match`` and ``distributed_skipper`` normalise it to ``None``.

* ``drop_proposals`` drops global-tier slots: on the wire in the
  distributed matcher, before the global tier in ``skipper_match`` (the
  same victims at D = 1: the mask is keyed by the slot's stream position).
* ``truncate_retry`` caps the retry buffer at ``k`` slots.
* ``corrupt_state`` writes the out-of-domain :data:`CORRUPT` into
  committed-state cells; such a cell is neither ACC nor MCHD, so it kills
  the edges on it: maximality breaks, validity never.
* ``lose_shard`` zeroes one device's (one window row's) window tier, state
  and matched bits together, and swallows its global-tier proposals.
* ``skip_drain`` forces the drain rounds to zero.

The victim masks are the reference's bit for bit, with no JAX:
``jax.random.bernoulli(fold_in(PRNGKey(seed), site), p, (n,))`` under
jax's partitionable Threefry-2x32, recomputed here in numpy
(:func:`_threefry2x32`, :func:`_bernoulli`).

**Recovery** (:func:`residual_replay`): the match mask is ground truth
(every fault keeps it valid); the state is not trusted. Rebuild the state
from the mask, collect the *residual* edges (valid, unmatched, neither
endpoint covered) and run ``engine.stream_pass`` over all ``m`` slots in
stream order, the non-residual ones as -1. Afterwards no valid edge is
free, so the matching is maximal; commits stay endpoint-disjoint, so it
stays valid. On the card that pass is the global-tier kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import ACC, MCHD, stream_pass
from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.graphs.types import EdgeList

__all__ = [
    "CORRUPT",
    "FaultPlan",
    "RecoveryReport",
    "corruption_mask",
    "proposal_drop_mask",
    "detect_residual",
    "residual_replay",
]

#: the out-of-domain state value ``corrupt_state`` writes (anything outside
#: {ACC=0, RSVD=1, MCHD=2}; 7 is visibly wrong in dumps)
CORRUPT = 7

# site keys folded into the plan's key, as in the reference
_SITE_DROP = 1
_SITE_CORRUPT = 2


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded, deterministic fault-injection plan (every site off by
    default). Two runs with the same plan and schedule inject the same
    faults, and the same as the reference's plan of the same fields."""

    seed: int = 0
    drop_proposals: float = 0.0          # P(drop) per global-tier slot
    truncate_retry: Optional[int] = None  # retry cap forced to min(cap, k)
    corrupt_state: float = 0.0           # P(corrupt) per committed cell
    lose_shard: Optional[int] = None     # rank (mod D) losing its window tier
    skip_drain: bool = False             # drain rounds forced to 0

    @property
    def active(self) -> bool:
        return (
            self.drop_proposals > 0.0
            or self.truncate_retry is not None
            or self.corrupt_state > 0.0
            or self.lose_shard is not None
            or self.skip_drain
        )


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What the degradation machinery saw and did (all zero on a clean
    run): ladder steps that did work, valid edges left undecided before
    the replay, matches the replay added, out-of-domain cells seen on the
    returned state."""

    recovery_attempts: int = 0
    residual_edges: int = 0
    recovered_matches: int = 0
    corrupted_cells: int = 0


# ------------------------------------------------------------ Threefry --
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: elements drawn per numpy pass (bounds the temporaries at a few 10s of MB)
_CHUNK = 1 << 22


def _threefry2x32(k0: int, k1: int, x0: np.ndarray,
                  x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """jax's Threefry-2x32 (20 rounds, a key injection every 4) on uint32
    arrays, which it overwrites (uint32 arithmetic wraps as jax's does)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    tmp = np.empty_like(x1)
    x0 += np.uint32(ks[0])
    x1 += np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=tmp)
            x1 >>= np.uint32(32 - r)
            x1 |= tmp
            x1 ^= x0
        x0 += np.uint32(ks[(i + 1) % 3])
        x1 += np.uint32((ks[(i + 2) % 3] + i + 1) & 0xFFFFFFFF)
    return x0, x1


def _site_key(seed: int, site: int) -> Tuple[int, int]:
    """``fold_in(PRNGKey(seed), site)``: ``PRNGKey`` keeps the seed's low
    32 bits as ``(0, seed)`` (jax without x64), and ``fold_in`` hashes the
    count ``(0, site)`` under it."""
    one = lambda x: np.asarray([x], np.uint32)  # noqa: E731
    key = np.concatenate(_threefry2x32(0, seed & 0xFFFFFFFF, one(0),
                                       one(site & 0xFFFFFFFF)))
    return int(key[0]), int(key[1])


def _bernoulli(seed: int, site: int, p: float, n: int) -> np.ndarray:
    """``jax.random.bernoulli(fold_in(PRNGKey(seed), site), p, (n,))``:
    element ``i`` hashes the count ``(i >> 32, i & 0xffffffff)``, its bits
    are ``x0 ^ x1``, the uniform is ``(bits >> 9 | 0x3f800000)`` as f32
    minus 1, and the draw is ``uniform < p`` in f32."""
    out = np.zeros((n,), bool)
    if n == 0 or p <= 0.0:
        return out
    k0, k1 = _site_key(int(seed), site)
    pf = np.float32(p)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        x0 = np.full((hi - lo,), lo >> 32, np.uint32)  # < 2^32 per chunk
        x1 = np.arange(lo & 0xFFFFFFFF, (lo & 0xFFFFFFFF) + hi - lo,
                       dtype=np.uint32)
        x0, x1 = _threefry2x32(k0, k1, x0, x1)
        x0 ^= x1
        x0 >>= np.uint32(9)
        x0 |= np.uint32(0x3F800000)
        out[lo:hi] = (x0.view(np.float32) - np.float32(1.0)) < pf
    return out


def proposal_drop_mask(plan: FaultPlan, num_slots: int,
                       device=None) -> torch.Tensor:
    """bool[num_slots] on ``device``: True where the plan drops a
    global-tier slot. Keyed only by ``(plan.seed, num_slots)``, so the
    distributed gather-drop and the single-device drop pick the same
    victims, and the reference's."""
    return torch.from_numpy(_bernoulli(plan.seed, _SITE_DROP,
                                       plan.drop_proposals,
                                       num_slots)).to(device)


def corruption_mask(plan: FaultPlan, num_cells: int,
                    device=None) -> torch.Tensor:
    """bool[num_cells] on ``device``: True where the plan corrupts a
    committed-state cell (cells in the state's own id space: renumbered
    flat for the windowed matchers, original ids for the dispersed one)."""
    return torch.from_numpy(_bernoulli(plan.seed, _SITE_CORRUPT,
                                       plan.corrupt_state,
                                       num_cells)).to(device)


# ------------------------------------------------------------ recovery --
def _rebuild_and_residual(e: EdgeList, match_mask: torch.Tensor,
                          state: torch.Tensor,
                          spec: Optional[StateSpec] = None):
    """The mask-rebuilt state (``spec.at_rest``), the residual-edge mask,
    and the out-of-domain cell count (int32) of the untrusted ``state``,
    read at any width. Slot ``n`` of the rebuild is the guard slot the
    reference's ``mode="drop"`` scatters and invalid reads go to."""
    spec = resolve_spec(spec)
    n = e.num_vertices
    valid = (e.u != e.v) & (e.u >= 0) & (e.v < n)
    sel = match_mask & valid
    rebuilt = torch.full((n + 1,), ACC, dtype=spec.at_rest_dtype,
                         device=e.u.device)
    rebuilt[torch.where(sel, e.u, n).long()] = MCHD
    rebuilt[torch.where(sel, e.v, n).long()] = MCHD
    su = rebuilt[torch.where(valid, e.u, n).long()]
    sv = rebuilt[torch.where(valid, e.v, n).long()]
    residual = valid & ~match_mask & (su != MCHD) & (sv != MCHD)
    corrupted = ((state != ACC) & (state != MCHD)).sum(dtype=torch.int32)
    return rebuilt[:n], residual, corrupted


def detect_residual(edges: EdgeList, match_mask: torch.Tensor,
                    state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(residual_edges, corrupted_cells)`` of a finished run, int32 0-d
    tensors on the mask's device: the detection half of the ladder
    (``on_fault="report"``, ``verify=``). Zero and zero iff the run
    upheld the definitive-decision invariant."""
    e = edges.to(match_mask.device).canonical()
    _, residual, corrupted = _rebuild_and_residual(e, match_mask, state)
    return residual.sum(dtype=torch.int32), corrupted


def residual_replay(
    edges: EdgeList,
    match_mask: torch.Tensor,
    state: torch.Tensor,
    *,
    tile_size: int = 256,
    vector_rounds: int = 1,
    spec: Optional[StateSpec] = None,
    backend: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """The recovery ladder's last rung: complete a possibly degraded
    matching into a valid maximal one of the uncorrupted graph, on the
    mask's device.

    Keeps ``match_mask`` (every modelled fault keeps it valid), rebuilds
    the state from it, and runs ``engine.stream_pass`` (``backend`` as
    there: the global-tier kernel on a CUDA device) over all ``m`` slots,
    the non-residual ones as -1, padded to a tile multiple. Returns
    ``(match_mask, state, residual_edges, recovered_matches,
    corrupted_cells)``, the counts int32 0-d tensors; the state is the
    clean rebuilt one at ``spec.at_rest``. Zero residual edges and zero
    corrupted cells mean the input was already maximal and clean, and the
    mask comes back unchanged."""
    spec = resolve_spec(spec)
    dev = match_mask.device
    e = edges.to(dev).canonical()
    n, m = e.num_vertices, e.num_edges
    rebuilt, residual, corrupted = _rebuild_and_residual(
        e, match_mask, state, spec)
    # only the residual edges reach the engine, in stream order: the
    # replay is one more single pass over the residual edges
    pad = torch.full(((-m) % tile_size,), -1, dtype=torch.int32, device=dev)
    ru = torch.cat([torch.where(residual, e.u, -1), pad])
    rv = torch.cat([torch.where(residual, e.v, -1), pad])
    final_state, matched, _ = stream_pass(
        rebuilt.contiguous(), ru, rv, n=n, vector_rounds=vector_rounds,
        tile_size=tile_size, backend=backend)
    matched = matched[:m]
    return (match_mask | matched, final_state,
            residual.sum(dtype=torch.int32), matched.sum(dtype=torch.int32),
            corrupted)
