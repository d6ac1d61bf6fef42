"""Step-level APRAM model of the single-pass reservation protocol (port of
``repro.testing.apram``: the same numpy model, kept as its own copy).

This is the ground truth every matcher of the port is conformance-checked
against (DESIGN.md §13). The model is deliberately tiny and dumb — plain
numpy, one python loop, no vectorization tricks — so that it can be read
against the paper's Alg. 1 line by line and trusted.

**The model.** ``n`` single-byte vertex cells, each ACC(0) or MCHD(2)
(RSVD(1) exists only *inside* an event — the paper's merged reserve+commit
makes the reservation window atomic, which is exactly the property being
modeled). One *event* per stream edge. A schedule is a permutation of the
event indices — the APRAM adversary's only power is choosing the order in
which the atomic events hit the cells. Each event, atomically:

    if both endpoint cells are ACC:  write MCHD to both; the edge MATCHES
    else:                            the edge is DEAD

Invalid stream slots (self-loops, negative ids, out-of-range endpoints —
the same validity predicate as ``core/validate.check_matching``) are
skipped events: decided, never matched, never touching a cell.

**Per-step invariants** (checked after every event unless
``check_every_step=False``):

* *state domain* — every cell is ACC or MCHD; a reservation never leaks.
* *no double-match* — a commit finds both cells ACC and unowned; matched
  edges are endpoint-disjoint by construction, and the model verifies it
  via the per-vertex ``owner`` map instead of assuming it.
* *monotone commit* — MCHD cells never revert; decisions never flip.
* *decision soundness* — a DEAD valid edge has an MCHD endpoint at the
  moment of death, and that endpoint is owned by a *matched* edge (this is
  the paper's "an edge is dead only if one of its endpoints is already
  matched"; the ownership half is what catches zombie reservations).

**Quiescence checks** (always, via :meth:`ApramResult.check_quiescent`):
every valid edge decided; validity + maximality of the matched mask via
``core/validate.check_matching``; and the final cell array must equal the
state rebuilt from the mask alone (no cell is MCHD without a committed
edge owning it, and vice versa).

**Mutations.** ``mutation=`` selects a seeded protocol bug — a model of a
*wrong* implementation of the merged step — which the invariant checks
must catch on contended schedules (the fuzz CLI's canary and the mutation
tests rely on this):

* ``commit_before_reserve`` — write MCHD to the first endpoint before the
  partner cell is checked; on conflict the half-commit is never rolled
  back (a zombie vertex: MCHD, owned by a dead edge).
* ``skip_partner_check`` — decide on the first endpoint alone; commits
  can double-book the partner vertex (validity violation).
* ``leak_reservation`` — on conflict, leave the first endpoint RSVD
  instead of rolling back (state-domain violation).
* ``drop_commit`` — report the edge matched but never write the cells
  (mask/state divergence; later neighbors double-match).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

ACC = 0
RSVD = 1
MCHD = 2

#: Protocol mutations the harness must catch (name -> doc). The values are
#: human-readable one-liners; the dispatch lives in :func:`_event`.
MUTATIONS = {
    "commit_before_reserve": "MCHD the first endpoint before checking the "
    "partner; never roll back (zombie vertex on conflict)",
    "skip_partner_check": "decide on the first endpoint alone; the partner "
    "cell can be double-booked",
    "leak_reservation": "leave RSVD in the first endpoint on conflict "
    "instead of rolling back",
    "drop_commit": "report matched without writing either cell",
}


class ApramViolation(AssertionError):
    """A per-step or quiescence invariant of the APRAM model failed.

    Carries ``step`` (position in the schedule), ``event`` (stream edge
    index) and ``invariant`` (short name) for machine consumption by the
    fuzzer's shrinker.
    """

    def __init__(self, message: str, *, step: int = -1, event: int = -1,
                 invariant: str = ""):
        super().__init__(message)
        self.step = step
        self.event = event
        self.invariant = invariant


@dataclasses.dataclass
class ApramResult:
    """Outcome of one scheduled APRAM execution.

    ``matched``/``decided`` are aligned with the STREAM order (not the
    schedule order); ``owner[w]`` is the stream index of the edge that
    committed vertex ``w`` (-1 while ACC); ``violations`` is non-empty only
    when the run was executed with ``strict=False``.
    """

    u: np.ndarray              # int64[m] canonical endpoints (u <= v)
    v: np.ndarray
    num_vertices: int
    schedule: np.ndarray       # int64[m] event order (a permutation)
    matched: np.ndarray        # bool[m]
    decided: np.ndarray        # bool[m]
    state: np.ndarray          # uint8[n]
    owner: np.ndarray          # int64[n]
    violations: list

    @property
    def num_matches(self) -> int:
        return int(self.matched.sum())

    def matching_key(self) -> bytes:
        """Hashable identity of the produced matching (for counting the
        distinct outcomes a schedule family can reach)."""
        return np.packbits(self.matched).tobytes()

    def check_quiescent(self) -> dict:
        """Quiescence checks; raises :class:`ApramViolation` on failure.

        Returns the ``core/validate.check_matching`` dict (host ints) so
        callers can also look at match counts.
        """
        valid = _valid_mask(self.u, self.v, self.num_vertices)
        undecided = valid & ~self.decided
        if undecided.any():
            k = int(np.flatnonzero(undecided)[0])
            raise ApramViolation(
                f"quiescence: valid edge ({self.u[k]}, {self.v[k]}) at "
                f"stream index {k} was never decided (not a single pass)",
                event=k, invariant="single_pass",
            )
        # cells must be exactly the mask-rebuilt state: MCHD iff covered
        # the model's cells are the paper's literal single bytes, not a
        # StateSpec tier — fixed width is the point
        rebuilt = np.zeros(self.num_vertices, np.uint8)  # state-dtype: ok
        sel = self.matched & valid
        rebuilt[self.u[sel]] = MCHD
        rebuilt[self.v[sel]] = MCHD
        if not np.array_equal(rebuilt, self.state):
            w = int(np.flatnonzero(rebuilt != self.state)[0])
            raise ApramViolation(
                f"quiescence: cell {w} is {int(self.state[w])} but the "
                f"matched mask implies {int(rebuilt[w])} (state/mask "
                "divergence)",
                invariant="state_mask_agreement",
            )
        out = _check_matching_host(
            self.u, self.v, self.num_vertices, self.matched
        )
        if not out["valid"]:
            raise ApramViolation(
                "quiescence: matched mask has endpoint collisions",
                invariant="validity",
            )
        if not out["maximal"]:
            raise ApramViolation(
                "quiescence: matched mask is not maximal",
                invariant="maximality",
            )
        return out


def _valid_mask(u: np.ndarray, v: np.ndarray, n: int) -> np.ndarray:
    """The exact validity predicate of ``core/validate.check_matching``:
    canonical u <= v, so ``v < n`` bounds both endpoints."""
    return (u != v) & (u >= 0) & (v < n)


def _check_matching_host(u, v, n, mask) -> dict:
    """Validity + maximality via ``core/validate.check_matching`` — the
    same code path the port's matchers are validated with — as host
    values. Imported lazily so the model itself stays numpy-only."""
    from repro_torch.core.validate import check_matching_arrays

    return check_matching_arrays(u, v, n, mask)


def _canonical(u, v) -> Tuple[np.ndarray, np.ndarray]:
    u = np.asarray(u, np.int64)
    v = np.asarray(v, np.int64)
    return np.minimum(u, v), np.maximum(u, v)


def run_schedule(
    edges,
    schedule: Sequence[int],
    *,
    mutation: Optional[str] = None,
    strict: bool = True,
    check_every_step: bool = True,
    check_quiescence: bool = True,
) -> ApramResult:
    """Execute the APRAM model under one schedule.

    Args:
        edges: an ``EdgeList`` (on any device) or ``(u, v, num_vertices)``
            tuple of arrays; endpoint
            order per edge is irrelevant (canonicalized like the matchers).
        schedule: permutation of ``range(m)`` — the event order. Checked;
            a non-permutation is a harness bug, not a protocol outcome.
        mutation: ``None`` (the paper's protocol) or a key of
            :data:`MUTATIONS`.
        strict: raise :class:`ApramViolation` at the first violated
            invariant (default). ``False`` records violations in
            ``result.violations`` and keeps going — the mutation tests use
            it to observe *what* a bug breaks.
        check_every_step: run the O(n) per-step sweeps (domain,
            monotonicity) after every event. The O(1) event-local checks
            (double-match, decision soundness) always run.
        check_quiescence: run :meth:`ApramResult.check_quiescent` at the
            end (strict mode only raises; non-strict records).

    Returns:
        :class:`ApramResult`.
    """
    if hasattr(edges, "num_vertices"):
        u, v = _canonical(*edges.to_numpy())
        n = int(edges.num_vertices)
    else:
        eu, ev, n = edges
        u, v = _canonical(eu, ev)
        n = int(n)
    m = u.shape[0]
    schedule = np.asarray(schedule, np.int64)
    if schedule.shape != (m,) or not np.array_equal(
        np.sort(schedule), np.arange(m)
    ):
        raise ValueError(
            f"schedule must be a permutation of range({m}), got shape "
            f"{schedule.shape}"
        )
    if mutation is not None and mutation not in MUTATIONS:
        raise ValueError(
            f"unknown mutation {mutation!r}; known: {sorted(MUTATIONS)}"
        )

    valid = _valid_mask(u, v, n)
    state = np.zeros(n, np.uint8)  # state-dtype: ok — the model IS the byte
    owner = np.full(n, -1, np.int64)
    matched = np.zeros(m, bool)
    decided = np.zeros(m, bool)
    violations: list = []
    mchd_count = 0

    def report(step, e, invariant, msg):
        err = ApramViolation(
            f"step {step} (edge {e}): {msg}", step=step, event=e,
            invariant=invariant,
        )
        if strict:
            raise err
        violations.append(err)

    for step, e in enumerate(schedule):
        e = int(e)
        if decided[e]:
            report(step, e, "single_pass", "edge touched twice")
            continue
        decided[e] = True
        if not valid[e]:
            continue
        a, b = int(u[e]), int(v[e])
        sa, sb = int(state[a]), int(state[b])

        if mutation is None:
            # Alg. 1, merged reserve+commit: one atomic event.
            if sa == ACC and sb == ACC:
                if owner[a] >= 0 or owner[b] >= 0:
                    report(step, e, "no_double_match",
                           "commit onto an already-owned ACC cell")
                state[a] = state[b] = MCHD
                owner[a] = owner[b] = e
                matched[e] = True
            else:
                matched[e] = False
        elif mutation == "commit_before_reserve":
            if sa == ACC:
                state[a] = MCHD        # the flip: commit u first...
                owner[a] = e
                if sb == ACC and b != a:
                    state[b] = MCHD    # ...then "reserve" (check) v
                    owner[b] = e
                    matched[e] = True
                # on conflict the half-commit is never rolled back
        elif mutation == "skip_partner_check":
            if sa == ACC:
                state[a] = state[b] = MCHD
                owner[a] = owner[b] = e   # may double-book b
                matched[e] = True
        elif mutation == "leak_reservation":
            if sa == ACC and sb == ACC:
                state[a] = state[b] = MCHD
                owner[a] = owner[b] = e
                matched[e] = True
            elif sa == ACC:
                state[a] = RSVD           # reservation never released
        elif mutation == "drop_commit":
            if sa == ACC and sb == ACC:
                matched[e] = True         # ...but the cells never hear
        # ---- event-local invariants (O(1)) --------------------------------
        if matched[e]:
            if int(state[a]) != MCHD or int(state[b]) != MCHD:
                report(step, e, "no_double_match",
                       "matched edge left a non-MCHD endpoint")
            elif owner[a] != e or owner[b] != e:
                report(step, e, "no_double_match",
                       f"matched edge does not own its endpoints "
                       f"(owners {owner[a]}, {owner[b]})")
        else:
            # dead valid edge: some endpoint MCHD, owned by a MATCHED edge
            dead_ok = False
            for w in (a, b):
                o = int(owner[w])
                if int(state[w]) == MCHD and o >= 0 and matched[o]:
                    dead_ok = True
            if not dead_ok:
                report(step, e, "decision_soundness",
                       "edge died without an endpoint matched by a "
                       "committed edge")
        # ---- per-step sweeps (O(n)) ---------------------------------------
        if check_every_step:
            bad = (state != ACC) & (state != MCHD)
            if bad.any():
                w = int(np.flatnonzero(bad)[0])
                report(step, e, "state_domain",
                       f"cell {w} holds out-of-domain value "
                       f"{int(state[w])} between events")
            new_count = int((state == MCHD).sum())
            if new_count < mchd_count:
                report(step, e, "monotone_commit",
                       "an MCHD cell reverted")
            mchd_count = new_count
            zombie = (state == MCHD) & (
                (owner < 0) | ~matched[np.clip(owner, 0, m - 1)]
            )
            if zombie.any():
                w = int(np.flatnonzero(zombie)[0])
                report(step, e, "no_double_match",
                       f"cell {w} is MCHD without a committed owner "
                       f"(owner={int(owner[w])})")

    result = ApramResult(
        u=u, v=v, num_vertices=n, schedule=schedule, matched=matched,
        decided=decided, state=state, owner=owner, violations=violations,
    )
    if check_quiescence:
        try:
            result.check_quiescent()
        except ApramViolation as err:
            if strict:
                raise
            violations.append(err)
    return result
