"""Seeded fuzzer for the single-pass reservation protocol, on the port's
matchers (the port's counterpart of ``tools/fuzz_matching.py``):

    python -m repro_torch.testing.fuzz [--device cuda] [--iterations 200]
    python -m repro_torch.testing.fuzz --replay tests/fuzz_corpus

Each iteration draws one adversarial graph instance (hubs, duplicate
edges, self-loops, invalid slots — always at a FIXED padded shape) and
runs it through:

* ``apram_sweep`` — the scheduler zoo (stream, hub-contention,
  round-robin, seeded-random) through the fully-checked step-level APRAM
  model (``repro_torch.testing.apram``);
* ``skipper_conformance`` — ``core/skipper.skipper``'s mask pinned as a
  reachable APRAM trace (``repro_torch.testing.oracle.pin_trace``);
* ``sgmm_conformance`` — the sequential-greedy oracle's mask pinned the
  same way (and cross-checked equal to the stream-order model run);
* ``bmatch_conformance`` — ``core/bipartite.bmatch_assign`` at
  budget=1/capacity=1 pinned via the bipartite stream mapping.

The matchers run on ``--device`` (default: the card, which the port's
entry points need unless given the CPU). On failure the instance is
SHRUNK (greedy edge invalidation — slots are replaced with ``-1``
padding, never removed, so shapes stay fixed) and the minimized
counterexample is written as JSON to ``--artifacts``.

``--mutation NAME`` seeds a protocol bug into the model
(``repro_torch.testing.apram.MUTATIONS``); the conformance checks are
skipped (they pin the *real* production code, which a model mutation
cannot break) and the run must exit 1 — the canary proving the fuzzer can
fail.

``--replay PATH...`` re-runs saved counterexamples (files or directories
of ``*.json``, the records of ``tools/fuzz_matching.py`` included: the
format and ``CORPUS_VERSION`` are the same) instead of fuzzing. A replay
only reads the records.

Exit codes: 0 clean, 1 counterexample found (or replay failure), 2
harness error.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.testing import (
    ApramViolation,
    ConformanceError,
    MUTATIONS,
    bipartite_stream,
    pin_trace,
    sweep,
)

# Fixed instance shape, the reference fuzzer's
NUM_VERTICES = 64
NUM_EDGES = 192
BM_TOKENS = 16
BM_EXPERTS = 8
BM_EDGES = 64

CORPUS_VERSION = 1


# --------------------------------------------------------------------------
# instance generation
# --------------------------------------------------------------------------
def make_instance(seed: int):
    """One adversarial graph instance at the fixed padded shape.

    Mixes edge sources so contention shapes the APRAM model is sensitive
    to (hub fan-in, chains, duplicates, self-loops) appear in every
    instance; ``-1`` slots model stream padding. The same numpy draws as
    the reference fuzzer, so a seed gives the same instance.
    """
    rng = np.random.default_rng(seed)
    n = NUM_VERTICES
    m = NUM_EDGES
    hubs = rng.integers(0, 6, m)                       # few hot vertices
    chain = (np.arange(m) % (n - 1))                   # path-like runs
    rand_u = rng.integers(0, n, m)
    rand_v = rng.integers(0, n, m)
    pick = rng.integers(0, 4, m)
    u = np.select([pick == 0, pick == 1, pick == 2], [hubs, chain, rand_u],
                  rand_u)
    v = np.select([pick == 0, pick == 1, pick == 2],
                  [rand_v, chain + 1, rand_v], rand_v)
    dup = rng.random(m) < 0.10                         # duplicate stream slots
    src = rng.integers(0, m, m)
    u = np.where(dup, u[src], u)
    v = np.where(dup, v[src], v)
    loop = rng.random(m) < 0.05                        # self-loops
    v = np.where(loop, u, v)
    pad = rng.random(m) < 0.08                         # invalid padding slots
    u = np.where(pad, -1, u)
    v = np.where(pad, -1, v)
    return u.astype(np.int64), v.astype(np.int64), n


def make_bmatch_instance(seed: int):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, BM_TOKENS, BM_EDGES).astype(np.int64)
    exp = rng.integers(0, BM_EXPERTS, BM_EDGES).astype(np.int64)
    tok = np.where(rng.random(BM_EDGES) < 0.1, -1, tok)
    return tok, exp


# --------------------------------------------------------------------------
# checks — each raises ApramViolation / ConformanceError on failure
# --------------------------------------------------------------------------
def _edgelist(u, v, n):
    from repro_torch.interop import edges_from_arrays

    return edges_from_arrays(u, v, n)


def check_apram_sweep(u, v, n, *, seed: int, mutation=None, device=None):
    sweep((u, v, n), seeds=(seed, seed + 1), threads=(2, 5),
          mutation=mutation, strict=True)


def check_skipper_conformance(u, v, n, *, seed: int, mutation=None,
                              device=None):
    from repro_torch.core.skipper import skipper

    res, _ = skipper(_edgelist(u, v, n), tile_size=32, device=device)
    pin_trace((u, v, n), res.match_mask, label="skipper")


def check_sgmm_conformance(u, v, n, *, seed: int, mutation=None,
                           device=None):
    from repro_torch.core.sgmm import sgmm
    from repro_torch.testing import run_schedule, stream_order

    # sgmm walks the stream on the host and returns CPU tensors
    mask = sgmm(_edgelist(u, v, n)).match_mask.numpy()  # host-sync: ok
    pin_trace((u, v, n), mask, label="sgmm")
    # sgmm IS the stream-order model run; they must agree exactly
    model = run_schedule((u, v, n), stream_order(len(u)))
    if not np.array_equal(model.matched, mask):
        k = int(np.flatnonzero(model.matched != mask)[0])
        raise ConformanceError(
            f"sgmm diverges from the stream-order APRAM run at index {k}",
            first_mismatch=k,
        )


def check_bmatch_conformance(u, v, n, *, seed: int, mutation=None,
                             device=None):
    # u/v are ignored — the bmatch stream has its own fixed shape
    from repro_torch.core.bipartite import bmatch_assign
    from repro_torch.device import resolve_device

    dev = resolve_device(device, "cuda", "bmatch_conformance")
    tok, exp = make_bmatch_instance(seed)
    accept = bmatch_assign(
        torch.from_numpy(tok.astype(np.int32)).to(dev),
        torch.from_numpy(exp.astype(np.int32)).to(dev),
        num_tokens=BM_TOKENS, num_experts=BM_EXPERTS,
        token_budget=1, expert_capacity=1, tile_size=16,
    )
    stream = bipartite_stream(tok, exp, num_tokens=BM_TOKENS,
                              num_experts=BM_EXPERTS)
    pin_trace(stream, accept, label="bmatch")


CHECKS = {
    "apram_sweep": check_apram_sweep,
    "skipper_conformance": check_skipper_conformance,
    "sgmm_conformance": check_sgmm_conformance,
    "bmatch_conformance": check_bmatch_conformance,
}
#: checks that exercise the model itself and honor ``mutation=``
MODEL_CHECKS = ("apram_sweep",)


# --------------------------------------------------------------------------
# shrinking + corpus
# --------------------------------------------------------------------------
def _fails(check, u, v, n, seed, mutation, device=None):
    try:
        CHECKS[check](u, v, n, seed=seed, mutation=mutation, device=device)
        return None
    except (ApramViolation, ConformanceError) as err:
        return err


def shrink(check: str, u, v, n, *, seed: int, mutation=None, device=None,
           max_rounds: int = 8):
    """Greedy minimization: invalidate one stream slot at a time (set it
    to ``-1`` padding — shapes never change) and keep the removal while
    the check still fails. Quadratic but the instances are tiny."""
    u, v = u.copy(), v.copy()
    for _ in range(max_rounds):
        progressed = False
        for i in range(len(u)):
            if u[i] == -1 and v[i] == -1:
                continue
            su, sv = u[i], v[i]
            u[i] = v[i] = -1
            if _fails(check, u, v, n, seed, mutation, device) is None:
                u[i], v[i] = su, sv        # removal heals it: keep the edge
            else:
                progressed = True
        if not progressed:
            break
    return u, v


def counterexample_record(check, u, v, n, *, seed, mutation, error):
    live = int(((u != -1) | (v != -1)).sum())  # host-sync: ok — numpy
    return {
        "version": CORPUS_VERSION,
        "check": check,
        "mutation": mutation,
        "seed": int(seed),
        "num_vertices": int(n),
        "u": [int(x) for x in u],
        "v": [int(x) for x in v],
        "live_edges": live,
        "error": f"{type(error).__name__}: {error}",
    }


def replay_record(rec, device=None) -> bool:
    """Re-run one corpus record on ``device``; True iff it now PASSES."""
    u = np.asarray(rec["u"], np.int64)
    v = np.asarray(rec["v"], np.int64)
    err = _fails(rec["check"], u, v, int(rec["num_vertices"]),
                 int(rec["seed"]), rec.get("mutation"), device)
    return err is None


def iter_corpus(paths):
    for p in paths:
        p = Path(p)
        files = sorted(p.glob("*.json")) if p.is_dir() else [p]
        for f in files:
            yield f, json.loads(f.read_text())


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------
def fuzz(args) -> int:
    checks = list(MODEL_CHECKS) if args.mutation else list(CHECKS)
    artifacts = Path(args.artifacts)
    deadline = time.monotonic() + args.time_budget
    found = 0
    it = 0
    while it < args.iterations and time.monotonic() < deadline:
        seed = args.seed + it
        u, v, n = make_instance(seed)
        for check in checks:
            err = _fails(check, u, v, n, seed, args.mutation, args.device)
            if err is None:
                continue
            found += 1
            su, sv = shrink(check, u, v, n, seed=seed,
                            mutation=args.mutation, device=args.device)
            rec = counterexample_record(
                check, su, sv, n, seed=seed, mutation=args.mutation,
                error=err)
            artifacts.mkdir(parents=True, exist_ok=True)
            out = artifacts / f"counterexample_{check}_seed{seed}.json"
            out.write_text(json.dumps(rec, indent=1))
            print(f"FAIL {check} seed={seed}: {rec['error']}")
            print(f"  minimized to {rec['live_edges']} live edges -> {out}")
            if found >= args.max_counterexamples:
                print(f"stopping after {found} counterexample(s)")
                return 1
        it += 1
        if args.verbose and it % 10 == 0:
            print(f"... {it} iterations clean "
                  f"({deadline - time.monotonic():.0f}s left)")
    status = "FOUND COUNTEREXAMPLES" if found else "clean"
    print(f"fuzz: {it} iterations x {len(checks)} checks "
          f"(seed base {args.seed}, mutation={args.mutation}, "
          f"device={args.device}): {status}")
    return 1 if found else 0


def replay(args) -> int:
    failed = 0
    total = 0
    for f, rec in iter_corpus(args.replay):
        total += 1
        ok = replay_record(rec, args.device)
        print(f"{'ok  ' if ok else 'FAIL'} {f.name} "
              f"({rec['check']}, {rec.get('live_edges', '?')} live edges)")
        failed += 0 if ok else 1
    print(f"replay: {total - failed}/{total} corpus records pass")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="base seed")
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--time-budget", type=float, default=120.0,
                    help="wall-clock budget in seconds")
    ap.add_argument("--device", default="cuda",
                    help="where the matchers run (default: the card)")
    ap.add_argument("--mutation", choices=sorted(MUTATIONS), default=None,
                    help="seed a protocol bug into the model (canary mode; "
                    "model checks only, MUST exit 1)")
    ap.add_argument("--artifacts", default="fuzz_artifacts",
                    help="directory for minimized counterexample JSON")
    ap.add_argument("--max-counterexamples", type=int, default=3)
    ap.add_argument("--replay", nargs="+", default=None, metavar="PATH",
                    help="replay corpus files/dirs instead of fuzzing")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    try:
        return replay(args) if args.replay else fuzz(args)
    except Exception:
        traceback.print_exc()
        return 2


if __name__ == "__main__":
    sys.exit(main())
