"""Adversarial schedulers for the APRAM model (port of
``repro.testing.scheduler``, pure numpy, kept as its own copy).

A *schedule* is a permutation of ``range(m)`` — the order in which the m
atomic edge events hit the vertex cells. The APRAM adversary controls
nothing else. This module is the zoo of adversaries the conformance suite
and the fuzzer draw from:

* :func:`stream_order` — the identity schedule; the fixpoint every
  matcher actually executes (sequential index-order greedy).
* :func:`random_schedule` — seeded uniform permutation.
* :func:`round_robin` — ``t`` "threads" are dealt contiguous blocks of
  the stream and the scheduler interleaves them one event per thread per
  round. This is the classic APRAM adversary: commit visibility from one
  thread's early edges lands between another thread's edges.
* :func:`hub_contention` — worst-case contention: events sorted so that
  edges touching the highest-degree vertices fire first (ties broken by
  reversed stream order). Maximizes the number of conflicting commits on
  shared cells early in the run.
* :func:`exhaustive_schedules` — every one of the m! interleavings, for
  tiny instances only (guarded by :data:`MAX_EXHAUSTIVE_EVENTS`).
* :func:`sweep` — convenience: run a named battery of the above through
  :func:`repro_torch.testing.apram.run_schedule` and return the results.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.testing.apram import ApramResult, run_schedule

#: Exhaustive enumeration is m! schedules; 8 events = 40320 runs of the
#: numpy model, a couple of seconds. Anything past this is a harness bug.
MAX_EXHAUSTIVE_EVENTS = 8


def _num_events(edges) -> int:
    if hasattr(edges, "num_vertices"):
        return int(edges.num_edges)
    return int(np.asarray(edges[0]).shape[0])


def stream_order(m: int) -> np.ndarray:
    """The identity schedule — the one every production matcher realizes."""
    return np.arange(m, dtype=np.int64)


def random_schedule(m: int, seed: int) -> np.ndarray:
    """Seeded uniform-random permutation of the events."""
    return np.random.default_rng(seed).permutation(m).astype(np.int64)


def round_robin(m: int, threads: int = 4) -> np.ndarray:
    """Deal the stream into ``threads`` contiguous blocks, then interleave
    one event per thread per round (thread 0 gets the remainder-padded
    first block). Models synchronous threads each scanning a shard of the
    stream at the same rate."""
    threads = max(1, min(int(threads), m)) if m else 1
    blocks = np.array_split(np.arange(m, dtype=np.int64), threads)
    out: List[int] = []
    for round_idx in range(max((len(b) for b in blocks), default=0)):
        for b in blocks:
            if round_idx < len(b):
                out.append(int(b[round_idx]))
    return np.asarray(out, np.int64)


def hub_contention(edges) -> np.ndarray:
    """Contention-first schedule: order events by descending max endpoint
    degree, breaking ties by *reversed* stream order, so the hub's edges
    (and among them the latest ones) fire before anything else. On a star
    this serializes every conflicting commit onto the hub cell up front —
    the opposite extreme from the stream order the matchers execute."""
    if hasattr(edges, "num_vertices"):
        u, v = (a.astype(np.int64) for a in edges.to_numpy())
        n = int(edges.num_vertices)
    else:
        u, v, n = (np.asarray(edges[0], np.int64),
                   np.asarray(edges[1], np.int64), int(edges[2]))
    m = u.shape[0]
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    valid = (lo != hi) & (lo >= 0) & (hi < n)
    deg = np.zeros(n + 1, np.int64)
    np.add.at(deg, np.where(valid, lo, n), 1)
    np.add.at(deg, np.where(valid, hi, n), 1)
    deg[n] = 0  # invalid-edge bucket
    edge_deg = np.maximum(deg[np.where(valid, lo, n)],
                          deg[np.where(valid, hi, n)])
    # lexsort: primary = -degree, secondary = -stream index
    order = np.lexsort((-np.arange(m), -edge_deg))
    return order.astype(np.int64)


def exhaustive_schedules(m: int) -> Iterator[np.ndarray]:
    """Yield every permutation of ``range(m)``. Refuses m >
    :data:`MAX_EXHAUSTIVE_EVENTS` — that is 40320 schedules already."""
    if m > MAX_EXHAUSTIVE_EVENTS:
        raise ValueError(
            f"exhaustive enumeration of {m}! schedules refused "
            f"(m > {MAX_EXHAUSTIVE_EVENTS}); use random_schedule sweeps"
        )
    for perm in itertools.permutations(range(m)):
        yield np.asarray(perm, np.int64)


def sweep(
    edges,
    *,
    seeds: Sequence[int] = (0, 1, 2, 3),
    threads: Sequence[int] = (2, 4),
    mutation: Optional[str] = None,
    strict: bool = True,
) -> List[ApramResult]:
    """Run the standard adversary battery over one instance.

    Battery = stream order, hub contention, round-robin at each thread
    count, and one random schedule per seed. Returns the
    :class:`~repro_torch.testing.apram.ApramResult` list (strict mode raises at
    the first invariant violation instead)."""
    m = _num_events(edges)
    schedules = [stream_order(m), hub_contention(edges)]
    schedules += [round_robin(m, t) for t in threads]
    schedules += [random_schedule(m, s) for s in seeds]
    return [
        run_schedule(edges, s, mutation=mutation, strict=strict)
        for s in schedules
    ]
