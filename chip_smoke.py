#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths on one NVIDIA card.

Run from the repository root, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py [--seed 0] [--scale 22]

Phases (any failure raises and exits non-zero):

1. Identity: the card's name, and its name and power limit from nvidia-smi.
2. Build: one nvcc for each kernel source (``skipper_match.cu``,
   ``flash_attention.cu``, and the analyzer's canaries ``mutants.cu``),
   all started together, for sm_90a, then their PTX the same way; the
   build times and ptxas reports are printed.
3. Kernel against plain version, on the card, bit for bit: both kernels,
   ``skipper_match`` and ``skipper_match_window`` against the plain PyTorch
   versions of ``ref.py`` on the same CUDA tensors, under
   ``StateSpec.u8()`` and ``legacy_i32()`` and ``vector_rounds`` 1 and 2,
   on small schedules (RMAT scale 14, the pinned odd shapes, all-boundary,
   same-block pairs, an empty global tier, a star, a path, and a stream
   with duplicates and self-loops). Tolerance: exact equality. On the
   RMAT scale-14 schedule, ``skipper_match_window`` (the window-tier
   kernel with one row) is also timed beside its plain version and bound.
4. Full scale: Graph500 RMAT (scale 22, edge factor 16) with window 65536,
   tile 256, degree reordering, uint8 state, one vector round. The main
   path runs once with the launch counts reset just before it; then the
   kernels and ``skipper_match`` are timed with CUDA events, each kernel is
   held bit for bit against its plain version on the same inputs, and the
   result must pass ``check_matching``, the state-domain check and the
   greedy certificate.
4a. Analysis: the port's kernel conformance analyzer
   (``repro_torch.analysis``) over ``src/repro_torch`` and every target
   (each template instance of the three production kernels, and the
   ``skipper_match``, ``flash_attention`` and serving decode-step entry
   points) must report no ERROR; each mutation canary must be caught by
   its named rule; the two canaries with plain versions
   (``swapped_writeback``, ``dynamic_gather``) must equal them bit for bit
   on the canonical schedule's global tier, where all three are timed. A
   JSON line gives the findings by rule and severity and each kernel's
   registers, shared memory and stack.
5. Flash attention: the kernel against its plain online-softmax version
   and against the model's chunked attention on the same CUDA inputs, in
   f32 and bf16, at granite-moe-3b-a800m's attention widths (S 128, 1024,
   4096, causal; one non-causal case) and at mixtral-8x7b's with its
   sliding window; then its path, the ``flash_attention`` entry point at
   granite's prefill_32k attention shape, once with the launch count reset
   just before it, and the kernel, its plain version and
   ``scaled_dot_product_attention`` timed there; the kernel is held against
   its plain version at that shape too, in bf16 and in f32.
6. Serving: ``repro_torch.launch.serve.serve`` on granite-moe-3b-a800m at
   full width and depth (bf16, seeded weights, Skipper router), 8 requests
   on 4 slots, prompts of 512, 32 new tokens, twice. The first run records
   every ``bmatch_assign`` call and each prefill's and decode step's
   logits; each call must equal the sequential greedy of its stream and
   respect every budget, and the logits must be finite. The second run is
   the timed one: it adds only a pair of CUDA events around each decode
   step's ``bmatch_assign`` call, whose spans give the router's share of
   the decode time; request 0's tokens must be the same in both. Eight
   decode steps are then traced with ``torch.profiler`` for the device's
   busy share and the kernels that take its time.
7. A ``{"kernels": [...]}`` line (the canaries with ``"status":
   "canary"``), the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when CUDA is unavailable or the
port's sources are missing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPLACES = {
    "skipper_window_tier_kernel":
        "src/repro/kernels/skipper_match/kernel.py:158",
    "skipper_boundary_kernel":
        "src/repro/kernels/skipper_match/kernel.py:196",
    "flash_attention_kernel":
        "src/repro/kernels/flash_attention/kernel.py:28",
}
SOURCE = "src/repro_torch/kernels/skipper_match/csrc/skipper_match.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
MUTANT_SOURCE = "src/repro_torch/analysis/csrc/mutants.cu"


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, reps: int = 1):
    """Best CUDA-event time of ``fn()`` over ``reps`` calls, in ms, and the
    last call's result."""
    times, out = [], None
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), out


def max_err(*pairs) -> int:
    """Largest |a - b| over pairs of integer tensors; raises on a shape or
    dtype mismatch."""
    err = 0
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(
                f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs "
                f"{tuple(b.shape)} {b.dtype}")
        if a.numel():
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def greedy_certificate(schedule, mask: torch.Tensor) -> None:
    """Exact O(E) proof that ``mask`` equals the sequential greedy matching
    over the schedule's slot order (window rows, then global-tier slots):
    the matching is valid and every valid unmatched slot p has an endpoint
    whose first matched slot lies before p."""
    s, dev = schedule, mask.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).long()

    base = put(s.window_ids)[:, None] * s.window
    wu, wv = put(s.u_tiles), put(s.v_tiles)
    su = torch.cat([torch.where(wu >= 0, wu + base, -1).reshape(-1),
                    put(s.boundary_u)])
    sv = torch.cat([torch.where(wv >= 0, wv + base, -1).reshape(-1),
                    put(s.boundary_v)])
    stream = torch.cat([put(s.edge_index).reshape(-1),
                        put(s.boundary_index)])
    real = stream >= 0
    taken = torch.zeros_like(real)
    taken[real] = mask[stream[real]]
    in_slots = torch.zeros_like(mask)
    in_slots[stream[real]] = True
    require(not bool(mask[~in_slots].any()),
            "certificate: an edge outside the schedule's slots is matched")
    n = s.num_windows * s.window
    ends = torch.cat([su[taken], sv[taken]])
    require(bool((torch.bincount(ends, minlength=n) <= 1).all()),
            "certificate: two matched slots share a vertex")
    pos = torch.arange(su.numel(), device=dev)
    first = torch.full((n,), su.numel(), dtype=torch.long, device=dev)
    first = first.scatter_reduce(0, ends, pos[taken].repeat(2), "amin")
    open_ = real & ~taken
    earlier = torch.minimum(first[su[open_]], first[sv[open_]])
    require(bool((earlier < pos[open_]).all()),
            "certificate: a valid unmatched slot has no endpoint matched "
            "earlier in slot order")


def random_stream(seed, n, m, *, dup=0.0, loops=0.0, invalid=0.0):
    """Numpy-seeded edge stream with optional duplicate slots, self-loops
    and (-1, -1) padding, canonical (u <= v)."""
    from repro_torch.interop import edges_from_arrays

    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    if dup:
        d = rng.random(m) < dup
        src = rng.integers(0, m, m)
        u, v = np.where(d, u[src], u), np.where(d, v[src], v)
    if loops:
        v = np.where(rng.random(m) < loops, u, v)
    if invalid:
        p = rng.random(m) < invalid
        u, v = np.where(p, -1, u), np.where(p, -1, v)
    return edges_from_arrays(np.minimum(u, v), np.maximum(u, v), n)


def small_cases():
    """(label, edges, window, tile, reorder) of phase 3."""
    from repro_torch.graphs import (
        erdos_renyi_graph, path_graph, rmat_graph, star_graph)
    from repro_torch.interop import edges_from_arrays

    cases = [("rmat14", rmat_graph(14, 16, seed=1), 2048, 256, "degree")]
    for n, w, t in ((701, 128, 64), (700, 256, 64), (901, 128, 32)):
        cases.append((f"pinned{n}_{w}_{t}", random_stream(n, n, 4 * n),
                      w, t, "none"))
    rng = np.random.default_rng(3)
    u = rng.integers(0, 128, 1500)
    v = rng.integers(128, 640, 1500)
    cases.append(("all_boundary", edges_from_arrays(u, v, 640), 128, 64,
                  "none"))
    rng = np.random.default_rng(4)
    u = np.concatenate([rng.integers(0, 128, 600), rng.integers(256, 384, 5)])
    v = np.concatenate([rng.integers(0, 128, 600), rng.integers(256, 384, 5)])
    cases.append(("same_block",
                  edges_from_arrays(np.minimum(u, v), np.maximum(u, v), 384),
                  128, 64, "none"))
    cases.append(("empty_global", erdos_renyi_graph(120, 400, seed=5), 128,
                  64, "none"))
    cases.append(("star", star_graph(3000), 512, 64, "none"))
    cases.append(("path", path_graph(5000), 512, 128, "none"))
    cases.append(("dups_loops", random_stream(7, 2000, 8000, dup=0.2,
                                              loops=0.1, invalid=0.05),
                  256, 64, "degree"))
    return cases


def put(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def tier_inputs(s, dev):
    nb = s.num_boundary_tiles
    return {
        "u2": put(s.u_tiles, dev), "v2": put(s.v_tiles, dev),
        "blk_u": put(s.boundary_blk_u, dev),
        "blk_v": put(s.boundary_blk_v, dev),
        "bu": put(s.boundary_ulocal, dev).reshape(nb, s.tile_size),
        "bv": put(s.boundary_vlocal, dev).reshape(nb, s.tile_size),
        "rows": put(s.window_ids, dev).long(),
    }


def compare_tiers(s, spec, vr, dev):
    """Both kernels against their plain versions on the same CUDA inputs;
    returns the max_abs_err of the window tier and of the global tier."""
    from repro_torch.kernels.skipper_match import kernel, ref

    x = tier_inputs(s, dev)
    state0 = torch.zeros((s.num_rows, s.window), dtype=spec.vmem_dtype,
                         device=dev)
    kw = dict(tile_size=s.tile_size, vector_rounds=vr, spec=spec)
    k_out = kernel.window_tier(x["u2"], x["v2"], state0, **kw)
    p_out = ref.ref_window_tier(x["u2"], x["v2"], state0, **kw)
    torch.cuda.synchronize()
    err_w = max_err(*zip(k_out, p_out))
    flat = torch.zeros((s.num_windows, s.window), dtype=spec.vmem_dtype,
                       device=dev)
    flat[x["rows"]] = p_out[0]
    err_b = 0
    if s.num_boundary_tiles:
        fk, fp = flat.clone(), flat.clone()
        args = (x["blk_u"], x["blk_v"], x["bu"], x["bv"])
        kb = kernel.boundary_tier(fk, *args, vector_rounds=vr, spec=spec)
        pb = ref.ref_boundary_pass(fp, *args, vector_rounds=vr, spec=spec)
        torch.cuda.synchronize()
        err_b = max_err((fk, fp), *zip(kb, pb))
    return err_w, err_b


def compare_match(edges, s, spec, vr, dev):
    """skipper_match and skipper_match_window, kernels against plain."""
    from repro_torch.core import check_matching, check_state_domain
    from repro_torch.kernels.skipper_match import (
        skipper_match, skipper_match_window)

    kw = dict(schedule=s, vector_rounds=vr, spec=spec, device=dev,
              with_conflicts=True)
    rk, ck = skipper_match(edges, backend="cuda", verify=True, **kw)
    rp, cp = skipper_match(edges, backend="torch", **kw)
    err = max_err((rk.match_mask, rp.match_mask), (rk.state, rp.state),
                  (ck, cp))
    for f in ("edge_reads", "state_loads", "state_stores", "rounds"):
        err = max(err, max_err((getattr(rk.counters, f),
                                getattr(rp.counters, f))))
    chk = check_matching(edges.to(dev), rk.match_mask)
    require(bool(chk["valid"]) and bool(chk["maximal"]),
            "check_matching failed")
    require(bool(check_state_domain(rk.state)["clean"]), "state domain")
    greedy_certificate(s, rk.match_mask)

    # one window from a seeded caller-given state with some MCHD cells
    rng = np.random.default_rng(s.window + vr)
    st0 = torch.from_numpy(
        np.where(rng.random(s.window) < 0.1, 2, 0).astype(np.uint8)).to(dev)
    u = put(s.u_tiles[0], dev)
    v = put(s.v_tiles[0], dev)
    wk = skipper_match_window(u, v, st0, s.tile_size, vr, backend="cuda",
                              spec=spec)
    wp = skipper_match_window(u, v, st0, s.tile_size, vr, backend="torch",
                              spec=spec)
    torch.cuda.synchronize()
    return max(err, max_err(*zip(wk, wp)))


def phase_small(dev):
    from repro_torch.core.statespec import StateSpec
    from repro_torch.graphs import build_window_schedule

    worst = {"skipper_window_tier_kernel": 0, "skipper_boundary_kernel": 0}
    t0 = time.perf_counter()
    for label, edges, window, tile, reorder in small_cases():
        s = build_window_schedule(edges, window, tile, reorder=reorder)
        for spec_name in ("u8", "legacy_i32"):
            spec = getattr(StateSpec, spec_name)()
            for vr in (1, 2):
                err_w, err_b = compare_tiers(s, spec, vr, dev)
                err_m = compare_match(edges, s, spec, vr, dev)
                log(f"  {label:>18} {spec_name:>10} rounds={vr} "
                    f"rows={s.num_rows}x{s.tiles_per_window} "
                    f"global_tiles={s.num_boundary_tiles} "
                    f"err window={err_w} boundary={err_b} match={err_m}")
                require(err_w == 0 and err_b == 0 and err_m == 0,
                        f"{label}/{spec_name}/rounds={vr}: kernel and plain "
                        "version disagree")
                worst["skipper_window_tier_kernel"] = max(
                    worst["skipper_window_tier_kernel"], err_w, err_m)
                worst["skipper_boundary_kernel"] = max(
                    worst["skipper_boundary_kernel"], err_b, err_m)
        if label == "rmat14":
            time_match_window(s, dev)
    log(f"phase 3 passed in {time.perf_counter() - t0:.1f} s")
    return worst


def time_match_window(s, dev) -> None:
    """``skipper_match_window`` (the window-tier kernel launched with one
    row, the port of ``skipper_window_kernel``) on the schedule's first
    row from an all-ACC state, u8, one vector round: launches on its path,
    kernel and plain times, and the byte bound (ids in, state in and out,
    matched and conflicts out)."""
    from repro_torch.kernels.skipper_match import kernel, skipper_match_window
    from repro_torch.roofline import h100

    u, v = put(s.u_tiles[0], dev), put(s.v_tiles[0], dev)
    st0 = torch.zeros(s.window, dtype=torch.uint8, device=dev)
    kernel.reset_launch_counts()
    skipper_match_window(u, v, st0, s.tile_size, 1)
    torch.cuda.synchronize()
    launches = kernel.launch_counts()["skipper_window_tier_kernel"]
    require(launches == 1, f"skipper_match_window launched {launches}")
    ms, got = cuda_time(lambda: skipper_match_window(
        u, v, st0, s.tile_size, 1, backend="cuda"), reps=3)
    plain_ms, want = cuda_time(lambda: skipper_match_window(
        u, v, st0, s.tile_size, 1, backend="torch"))
    err = max_err(*zip(got, want))
    require(err == 0, "skipper_match_window: kernel and plain disagree")
    nbytes = 8 * u.numel() + 2 * s.window + 2 * u.numel()
    log("skipper_match_window metrics: " + json.dumps({
        "schedule": f"rmat14 row 0, window {s.window}, "
                    f"{s.tiles_per_window} tiles of {s.tile_size}",
        "launches_on_path": launches, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": h100.bytes_ms(nbytes), "bound_by": "bytes",
        "max_abs_err": err}))


def phase_full(dev, seed: int, scale: int, worst):
    from repro_torch.core import check_matching, check_state_domain
    from repro_torch.core.statespec import StateSpec
    from repro_torch.graphs import build_window_schedule, rmat_graph
    from repro_torch.kernels.skipper_match import kernel, ref, skipper_match
    from repro_torch.roofline import h100

    spec = StateSpec.u8()
    window, tile, vr = 65536, 256, 1
    t0 = time.perf_counter()
    edges = rmat_graph(scale, 16, seed=seed, a=0.57, b=0.19, c=0.19)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s = build_window_schedule(edges, window, tile, reorder="degree")
    sched_s = time.perf_counter() - t0
    shape = {
        "scale": scale, "edge_factor": 16, "seed": seed,
        "vertices": s.num_vertices, "edges": s.num_edges,
        "valid_edges": s.num_valid, "window": window, "tile": tile,
        "rows": s.num_rows, "tiles_per_row": s.tiles_per_window,
        "global_tiles": s.num_boundary_tiles,
        "pairs": s.num_boundary_pairs,
        "padding_waste": s.padding_waste,
        "windowed_fraction": s.windowed_fraction,
        "generate_s": gen_s, "schedule_s": sched_s,
    }
    log("full-scale schedule: " + json.dumps(shape))

    # the main path, once, through the user's entry point
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    res, conf = skipper_match(edges, schedule=s, vector_rounds=vr, spec=spec,
                              with_conflicts=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernel.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: {first_s:.3f} s (first call), launches {launches}, "
        f"peak device memory {peak} B")
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path was not launched: {launches}")

    edges_dev = edges.to(dev)
    chk = check_matching(edges_dev, res.match_mask)
    dom = check_state_domain(res.state)
    require(bool(chk["valid"]) and bool(chk["maximal"]),
            f"full scale: check_matching failed {chk}")
    require(bool(dom["clean"]), f"full scale: state domain {dom}")
    greedy_certificate(s, res.match_mask)
    log(f"full scale: valid maximal matching of "
        f"{int(chk['num_matches'])} edges, state clean, greedy certificate "
        "holds")

    # end to end on the prebuilt schedule (warm): best of 2, events and
    # host clock
    match_times, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        ms, _ = cuda_time(lambda: skipper_match(
            edges, schedule=s, vector_rounds=vr, spec=spec))
        walls.append(time.perf_counter() - t0)
        match_times.append(ms)
    match_ms, wall_s = min(match_times), min(walls)
    # the part of that call that copies the schedule to the card
    copied = (s.u_tiles, s.v_tiles, s.window_ids, s.boundary_blk_u,
              s.boundary_blk_v, s.boundary_ulocal, s.boundary_vlocal,
              s.stream_src, s.perm)
    copy_ms, _ = cuda_time(lambda: [put(a, dev) for a in copied], reps=2)

    # each kernel on the main path's inputs, against its plain version
    x = tier_inputs(s, dev)
    state0 = torch.zeros((s.num_rows, window), dtype=spec.vmem_dtype,
                         device=dev)
    kw = dict(tile_size=tile, vector_rounds=vr, spec=spec)
    w_ms, w_out = cuda_time(
        lambda: kernel.window_tier(x["u2"], x["v2"], state0, **kw), reps=2)
    wp_ms, wp_out = cuda_time(
        lambda: ref.ref_window_tier(x["u2"], x["v2"], state0, **kw))
    err_w = max_err(*zip(w_out, wp_out))
    log(f"window tier: kernel {w_ms:.3f} ms, plain {wp_ms:.1f} ms, "
        f"max_abs_err {err_w}")
    flat = torch.zeros((s.num_windows, window), dtype=spec.vmem_dtype,
                       device=dev)
    flat[x["rows"]] = w_out[0]
    args = (x["blk_u"], x["blk_v"], x["bu"], x["bv"])
    b_times = []
    for _ in range(2):
        fk = flat.clone()
        ms, b_out = cuda_time(lambda: kernel.boundary_tier(
            fk, *args, vector_rounds=vr, spec=spec))
        b_times.append(ms)
    b_ms = min(b_times)
    fp = flat.clone()
    bp_ms, bp_out = cuda_time(lambda: ref.ref_boundary_pass(
        fp, *args, vector_rounds=vr, spec=spec))
    err_b = max_err((fk, fp), *zip(b_out, bp_out))
    log(f"global tier: kernel {b_ms:.3f} ms, plain {bp_ms:.1f} ms, "
        f"max_abs_err {err_b}")
    require(err_w == 0 and err_b == 0,
            "full scale: kernel and plain version disagree")
    worst["skipper_window_tier_kernel"] = max(
        worst["skipper_window_tier_kernel"], err_w)
    worst["skipper_boundary_kernel"] = max(
        worst["skipper_boundary_kernel"], err_b)

    metrics = {
        "skipper_match_ms_events": match_ms,
        "skipper_match_wall_s": wall_s,
        "medges_per_s": s.num_valid / (match_ms * 1e-3) / 1e6,
        "window_tier_ms": w_ms, "global_tier_ms": b_ms,
        "schedule_copy_ms": copy_ms,
        "peak_device_bytes": peak,
    }
    log("full-scale metrics: " + json.dumps(metrics))
    log("bound_ms counts the bytes each kernel must move at 3.35 TB/s; the "
        "serial chain of tiles in one block, not bytes, limits both today")
    bounds = {
        "skipper_window_tier_kernel": h100.window_bytes(s, spec),
        "skipper_boundary_kernel": h100.boundary_bytes(s, spec),
    }
    times = {"skipper_window_tier_kernel": (w_ms, wp_ms),
             "skipper_boundary_kernel": (b_ms, bp_ms)}
    return [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name][0],
         "plain_ms": times[name][1],
         "bound_ms": h100.bytes_ms(bounds[name]),
         "bound_by": "bytes", "library_ms": None}
        for name in ("skipper_window_tier_kernel", "skipper_boundary_kernel")
    ]


# --------------------------------------------------------------- phase 4a --
def phase_analysis(dev):
    """The analyzer over the tree and every target, then each canary; the
    canaries' entries of the kernels line."""
    from repro_torch.analysis import analyze_mutation, mutations, run_analysis
    from repro_torch.analysis import targets as atargets
    from repro_torch.analysis.report import Severity
    from repro_torch.analysis.runner import caught
    from repro_torch.core.statespec import DEFAULT
    from repro_torch.kernels.skipper_match import ref
    from repro_torch.roofline import h100

    t0 = time.perf_counter()
    report = run_analysis(paths=[str(ROOT / "src" / "repro_torch")])
    tree_s = time.perf_counter() - t0
    by_rule = {}
    for f in report.findings:
        by_rule.setdefault(f.rule, {}).setdefault(f.severity.value, 0)
        by_rule[f.rule][f.severity.value] += 1
    for f in report.findings:
        if f.severity is not Severity.INFO:
            log("  " + f.render())
    require(report.clean, f"analysis: {len(report.errors)} ERROR finding(s) "
            "on the production tree")

    # each kernel's registers, shared memory and stack, from the findings
    facts = {}
    keys = {"registers": "registers", "smem-budget": "bytes",
            "local-memory": "stack_frame"}

    def read_facts(rep):
        for f in rep.findings:
            if f.rule in keys and f.data:
                facts.setdefault(f.where, {})[f.rule] = f.data[keys[f.rule]]

    read_facts(report)
    t1 = time.perf_counter()
    mutations.reset_launch_counts()
    caught_by = {}
    for name in mutations.MUTATION_NAMES:
        r = analyze_mutation(name)
        read_facts(r)
        caught_by[name] = sorted({f.rule for f in r.errors})
        log(f"  mutation {name}: ERROR from {caught_by[name]} "
            f"(expected {mutations.EXPECTED_RULE[name]})")
        require(caught(name, r), f"mutation {name} was not caught by "
                f"{mutations.EXPECTED_RULE[name]}: the analyzer lost its "
                "teeth")
    launches = mutations.launch_counts()
    mutations_s = time.perf_counter() - t1
    require(all(n > 0 for n in launches.values()),
            f"a canary was not launched on the analyzer's path: {launches}")

    # the canaries on the canonical schedule: against their plain versions,
    # and timed beside them
    s = atargets.canonical_schedule(1)
    x = tier_inputs(s, dev)
    state0 = torch.zeros((s.num_rows, s.window), dtype=DEFAULT.vmem_dtype,
                         device=dev)
    rows, _, _ = ref.ref_window_tier(x["u2"], x["v2"], state0,
                                     tile_size=s.tile_size, spec=DEFAULT)
    flat = torch.zeros((s.num_windows, s.window), dtype=DEFAULT.vmem_dtype,
                       device=dev)
    flat[x["rows"]] = rows
    targs = (x["blk_u"], x["blk_v"], x["bu"], x["bv"])
    entries, errs = [], {}
    for name, m in mutations.KERNEL_MUTATIONS.items():
        if m.role == "window":
            def run(fn, name=name):
                return fn(name, x["u2"], x["v2"], state0,
                          tile_size=s.tile_size)
            bound = h100.window_bytes(s, DEFAULT)
        else:
            def run(fn, name=name):
                st = flat.clone()
                return (st, *fn(name, st, *targs))
            bound = h100.boundary_bytes(s, DEFAULT)
        launch = (mutations.window_tier if m.role == "window"
                  else mutations.boundary_tier)
        ms, got = cuda_time(lambda: run(launch), reps=3)
        plain_ms, want = cuda_time(lambda: run(mutations.plain))
        errs[name] = max_err(*zip(got, want))
        if name != "dropped_dma_wait":
            require(errs[name] == 0, f"canary {name} differs from its plain "
                    f"version (max_abs_err {errs[name]})")
        entries.append({
            "name": m.kernel, "route": "cuda", "source": MUTANT_SOURCE,
            "replaces": m.replaces, "status": "canary",
            "launches": launches[m.kernel], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": h100.bytes_ms(bound),
            "bound_by": "bytes", "library_ms": None})
    log("analysis: " + json.dumps({
        "findings": by_rule, "targets": len(report.targets_analyzed),
        "files": report.files_analyzed, "caught_by": caught_by,
        "canary_launches": launches,
        "canary_max_abs_err_vs_plain": errs,
        "kernels": facts, "tree_s": tree_s, "mutations_s": mutations_s,
        "seconds": time.perf_counter() - t0}))
    log("dropped_dma_wait races by design: its max_abs_err is against the "
        "production plain version and may be 0 in a run")
    return entries


# ---------------------------------------------------------------- phase 5 --
# Tolerances of the flash kernel against its plain version on the same
# inputs: f32 2e-5 (both sum in f32, in other orders: FMA chains against
# the f32 products of einsum with TF32 off; the JAX package's own kernel
# test uses 2e-5); bf16 2e-2 (the JAX package's bf16 tolerance) and, element
# by element, one bf16 step of the plain value plus 1e-6: both compute the
# same f32 result to within about 1e-6 and round it to bf16 once, so they
# may land one step apart, never two. Against the model's chunked
# attention: f32 1e-4 (the JAX package's kernel-against-model tolerance);
# bf16 6e-2, because the chunked form rounds q * scale and p to bf16 by
# design (2^-9 relative each, on scores and outputs of magnitude up to
# about 4: about 3e-2), where the kernel keeps both in f32, and each side
# then rounds its output once.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 6e-2)}
BF16_STEP_FLOOR = 1e-6
GRANITE_ATTN = dict(b=1, hq=24, hkv=8, d=64)
MIXTRAL_ATTN = dict(b=1, hq=32, hkv=8, d=128)


def flash_inputs(gen, b, hq, hkv, s, d, dtype, dev):
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers just above |x| (2^(floor(log2|x|) - 7),
    0 at 0), in f32."""
    _, e = torch.frexp(x.float())
    step = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, 0.0, step)


def compare_flash(got: torch.Tensor, plain: torch.Tensor) -> Tuple[float,
                                                                   bool]:
    """max |got - plain|, and whether it is within the stated tolerance:
    2e-5 in f32; in bf16 2e-2 and, element by element, one bf16 step of
    the plain value plus ``BF16_STEP_FLOOR``."""
    diff = (got.float() - plain.float()).abs()
    err = diff.max().item()
    ok = err <= FLASH_TOL[got.dtype][0]
    if got.dtype == torch.bfloat16:
        ok &= bool((diff <= bf16_step(plain) + BF16_STEP_FLOOR).all())
    return err, ok


def flash_cases():
    """(label, widths, S, causal, window) of phase 5."""
    cases = [(f"granite S={s}", GRANITE_ATTN, s, True, 0)
             for s in (128, 1024, 4096)]
    cases.append(("granite S=1024 non-causal", GRANITE_ATTN, 1024, False, 0))
    cases.append(("mixtral S=8192 window=4096", MIXTRAL_ATTN, 8192, True,
                  4096))
    return cases


def phase_flash(dev, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, kernel
    from repro_torch.kernels.flash_attention.ref import (
        online_softmax_attention)
    from repro_torch.models.layers import gqa_attention_chunked
    from repro_torch.roofline import h100

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    t0 = time.perf_counter()
    for label, w, s, causal, window in flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            tol_plain, tol_model = FLASH_TOL[dtype]
            q, k, v = flash_inputs(gen, w["b"], w["hq"], w["hkv"], s, w["d"],
                                   dtype, dev)
            blk = min(128, s)
            got = kernel.flash_attention_cuda(
                q, k, v, causal=causal, window=window,
                sm_scale=w["d"] ** -0.5, block_q=blk, block_k=blk)
            plain = online_softmax_attention(q, k, v, block_q=blk,
                                             block_k=blk, causal=causal,
                                             window=window)
            model = gqa_attention_chunked(
                *(t.transpose(1, 2) for t in (q, k, v)), causal=causal,
                window=window).transpose(1, 2)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
            err, ok = compare_flash(got, plain)
            err_model = (got.float() - model.float()).abs().max().item()
            log(f"  flash {label:>28} {str(dtype)[6:]:>8}: kernel-plain "
                f"{err:.3e} (tol {tol_plain}"
                f"{', one bf16 step' if dtype == torch.bfloat16 else ''}), "
                f"kernel-model {err_model:.3e} (tol {tol_model})")
            require(ok and err_model <= tol_model,
                    f"flash {label} {dtype}: kernel and plain version or "
                    "model attention disagree")
            worst = max(worst, err)
            del q, k, v, got, plain, model

    # the path: the entry point at granite's prefill_32k attention shape
    w, s = GRANITE_ATTN, 32768
    q, k, v = flash_inputs(gen, w["b"], w["hq"], w["hkv"], s, w["d"],
                           torch.bfloat16, dev)
    kernel.reset_launch_counts()
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = kernel.launch_counts()[kernel.FLASH]
    require(launches > 0, "flash_attention did not launch its kernel")
    require(bool(torch.isfinite(out).all()), "prefill_32k: non-finite")
    kw = dict(causal=True, window=0, sm_scale=w["d"] ** -0.5, block_q=128,
              block_k=128)
    ms, got = cuda_time(lambda: kernel.flash_attention_cuda(q, k, v, **kw),
                        reps=3)
    cuda_time(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))           # warm-up
    lib_ms, lib = cuda_time(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=3)
    plain_ms, plain = cuda_time(lambda: online_softmax_attention(
        q, k, v, block_q=128, block_k=128, causal=True))
    err, ok = compare_flash(got, plain)
    err_lib = (got.float() - lib.float()).abs().max().item()
    require(ok, f"prefill_32k bf16: kernel and plain version disagree "
            f"({err}, tolerance 2e-2 and one bf16 step)")
    worst = max(worst, err)
    bound, bound_by = h100.flash_bound_ms(w["b"], w["hq"], w["hkv"], s,
                                          w["d"], 2)
    del q, k, v, out, got, lib, plain
    # the same shape in f32, held at 2e-5
    q, k, v = flash_inputs(gen, w["b"], w["hq"], w["hkv"], s, w["d"],
                           torch.float32, dev)
    got = kernel.flash_attention_cuda(q, k, v, **kw)
    plain = online_softmax_attention(q, k, v, block_q=128, block_k=128,
                                     causal=True)
    err_f32, ok = compare_flash(got, plain)
    require(ok, f"prefill_32k f32: kernel and plain version disagree "
            f"({err_f32}, tolerance 2e-5)")
    worst = max(worst, err_f32)
    del q, k, v, got, plain
    # kernel and plain version beside each other at S = 4096
    q, k, v = flash_inputs(gen, w["b"], w["hq"], w["hkv"], 4096, w["d"],
                           torch.bfloat16, dev)
    ms_4k, _ = cuda_time(lambda: kernel.flash_attention_cuda(q, k, v, **kw),
                         reps=3)
    plain_4k, _ = cuda_time(lambda: online_softmax_attention(
        q, k, v, block_q=128, block_k=128, causal=True), reps=2)
    del q, k, v
    metrics = {
        "shape": "B=1 S=32768 Hq=24 Hkv=8 D=64 causal bf16",
        "kernel_ms": ms, "plain_ms": plain_ms, "sdpa_ms": lib_ms,
        "bound_ms": bound, "bound_by": bound_by,
        "kernel_vs_plain_err": err, "kernel_vs_plain_err_f32": err_f32,
        "kernel_vs_sdpa_err": err_lib,
        "kernel_ms_s4096": ms_4k, "plain_ms_s4096": plain_4k,
        "launches_on_path": launches,
        "seconds": time.perf_counter() - t0,
    }
    log("flash metrics: " + json.dumps(metrics))
    return {"name": "flash_attention_kernel", "route": "cuda",
            "source": FLASH_SOURCE,
            "replaces": REPLACES["flash_attention_kernel"],
            "launches": launches, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib_ms}


# ---------------------------------------------------------------- phase 6 --
def greedy_bmatch(tok, exp, n_tok, n_exp, budget, cap):
    """Sequential greedy b-matching in stream order (numpy oracle)."""
    used_t = np.zeros(n_tok, np.int64)
    used_e = np.zeros(n_exp, np.int64)
    out = np.zeros(len(tok), bool)
    for i, (t, e) in enumerate(zip(tok.tolist(), exp.tolist())):
        if t >= 0 and used_t[t] < budget and used_e[e] < cap:
            out[i] = True
            used_t[t] += 1
            used_e[e] += 1
    return out


class Recorder:
    """Test hook around the serving path: swaps ``moe.bmatch_assign`` and
    the adapters' ``prefill_fn``/``decode_fn`` for wrappers that record
    every b-matching call (its stream, budgets and accept mask) and whether
    all logits were finite, and puts the originals back on exit."""

    def __init__(self):
        from repro_torch.launch import adapters
        from repro_torch.models import moe

        self.moe, self.adapters = moe, adapters
        self.calls = []
        self.finite = True
        self.logit_calls = 0

    def _bmatch(self, fn):
        def wrapped(token_ids, expert_ids, **kw):
            acc = fn(token_ids, expert_ids, **kw)
            self.calls.append((token_ids.cpu().numpy(),
                               expert_ids.cpu().numpy(), acc.cpu().numpy(),
                               kw))
            return acc
        return wrapped

    def _logits(self, fn):
        def wrapped(*args, **kw):
            logits, cache = fn(*args, **kw)
            self.finite &= bool(torch.isfinite(logits).all())
            self.logit_calls += 1
            return logits, cache
        return wrapped

    def __enter__(self):
        self.saved = (self.moe.bmatch_assign, self.adapters.prefill_fn,
                      self.adapters.decode_fn)
        self.moe.bmatch_assign = self._bmatch(self.saved[0])
        self.adapters.prefill_fn = self._logits(self.saved[1])
        self.adapters.decode_fn = self._logits(self.saved[2])
        return self

    def __exit__(self, *exc):
        (self.moe.bmatch_assign, self.adapters.prefill_fn,
         self.adapters.decode_fn) = self.saved
        return False


class BmatchTimer:
    """Test hook for the timed serving run: swaps ``moe.bmatch_assign`` for
    a wrapper that records a CUDA event before and after each decode-step
    call (one token), with no sync and no copy (two event records a call
    are its whole cost), and puts the original back on exit. ``seconds``
    sums the device-timeline spans of the calls once the run has ended."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.events = []

    def __enter__(self):
        self.saved = self.moe.bmatch_assign

        def wrapped(token_ids, expert_ids, **kw):
            if kw["num_tokens"] != 1:
                return self.saved(token_ids, expert_ids, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            acc = self.saved(token_ids, expert_ids, **kw)
            end.record()
            self.events.append((start, end))
            return acc
        self.moe.bmatch_assign = wrapped
        return self

    def __exit__(self, *exc):
        self.moe.bmatch_assign = self.saved
        return False

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


def profile_decode(arch: str, dev, seed: int, prompt_len: int,
                   steps: int = 8) -> dict:
    """Trace ``steps`` decode steps of one request with ``torch.profiler``
    (the serve path's own steps on a model drawn as ``serve`` draws it):
    the device's busy share of the traced wall time (the sum of kernel
    times over it; the profiler's own host cost makes the idle share an
    upper bound) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import adapters
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = get_config(arch)
    model = adapters.init_fn(torch.Generator(device=dev).manual_seed(seed),
                             cfg)
    prompt = torch.randint(3, cfg.vocab_size, (1, prompt_len),
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed), device=dev)
    logits, cache = make_prefill_step(cfg)(model, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    step = make_serve_step(cfg)
    tok, cache = step(model, cache, tok)     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache = step(model, cache, tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): an operator's own row
        # repeats the device time of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    del model, cache
    if not rows:
        log("profiler: no device time recorded; busy share not measured")
        return {"profiled_decode_steps": steps, "device_busy_share": None}
    return {
        "profiled_decode_steps": steps,
        "profiled_ms_per_step": wall_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ms_per_step": busy_us / steps / 1e3,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_step": us / steps / 1e3,
             "launches_per_step": n / steps} for us, k, n in rows[:8]],
    }


def phase_serve(dev, seed: int):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch.serve import serve

    arch = "granite-moe-3b-a800m"
    cfg = get_config(arch)
    kw = dict(num_requests=8, slots=4, prompt_len=512, max_new=32,
              seed=seed, device=dev)
    t0 = time.perf_counter()
    flash.reset_launch_counts()
    with Recorder() as rec:
        out1, st1 = serve(arch, False, **kw)
    flash_launches = flash.launch_counts()[flash.FLASH]
    require(rec.finite and rec.logit_calls > 0,
            "serving: non-finite logits")
    checked = 0
    for tok, exp, acc, ckw in rec.calls:
        want = greedy_bmatch(tok, exp, ckw["num_tokens"], ckw["num_experts"],
                             ckw["token_budget"], ckw["expert_capacity"])
        require(np.array_equal(acc, want),
                f"bmatch_assign call {checked} differs from the sequential "
                "greedy of its stream")
        ok = acc & (tok >= 0)
        require(np.bincount(tok[ok], minlength=ckw["num_tokens"]).max(
                    initial=0) <= ckw["token_budget"]
                and np.bincount(exp[ok], minlength=ckw["num_experts"]).max(
                    initial=0) <= ckw["expert_capacity"],
                f"bmatch_assign call {checked} over-fills a budget")
        checked += 1
    decode_calls = sum(c[3]["num_tokens"] == 1 for c in rec.calls)
    log(f"serving run 1 (recorded): {checked} bmatch_assign calls equal "
        f"the greedy oracle ({decode_calls} in decode steps), "
        f"{rec.logit_calls} logits finite")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with BmatchTimer() as timer:
        out2, st2 = serve(arch, False, **kw)
    peak = torch.cuda.max_memory_allocated()
    bmatch_decode_s = timer.seconds()
    require(len(timer.events) > 0,
            "timed run: no bmatch_assign call in a decode step")
    require(out1[0] == out2[0], "serving: request 0 differs between runs")
    require(all(len(v) == kw["max_new"] or v[-1] == 2 for v in out2.values()),
            "serving: a request stopped early without EOS")
    metrics = {
        "arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "experts": cfg.num_experts, "top_k": cfg.num_experts_per_tok,
        "router": cfg.moe_router, "dtype": cfg.dtype,
        "requests": kw["num_requests"], "slots": kw["slots"],
        "prompt_len": kw["prompt_len"], "max_new": kw["max_new"],
        "prefill_ms_per_request": 1e3 * sum(st2["prefill_s"])
        / len(st2["prefill_s"]),
        "prefill_ms_each": [1e3 * x for x in st2["prefill_s"]],
        "decode_tokens_per_s": st2["decoded"] / st2["decode_s"],
        "decoded": st2["decoded"], "decode_s": st2["decode_s"],
        "total_s": st2["total_s"], "peak_device_bytes": peak,
        "bmatch_calls": checked,
        "bmatch_share_of_decode": bmatch_decode_s / st2["decode_s"],
        "bmatch_ms_per_decode_call": 1e3 * bmatch_decode_s
        / len(timer.events),
        "recorded_run_decode_s": st1["decode_s"],
        "flash_launches_on_serving_path": flash_launches,
        "request0_tokens": out2[0][:8],
        "seconds": time.perf_counter() - t0,
    }
    metrics.update(profile_decode(arch, dev, seed, kw["prompt_len"]))
    log("serving metrics: " + json.dumps(metrics))
    log("flash_attention_kernel launches on the serving path: "
        f"{flash_launches} (the model's attention is the plain chunked form, "
        "as in the JAX package)")



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the full-scale RMAT graph, the attention "
                    "inputs and the served model's weights")
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale of the full-scale phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import mutations
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.skipper_match import kernel

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(smi)

    t0 = time.perf_counter()
    sources = (kernel.SOURCE, flash.SOURCE, mutations.SOURCE)
    built = _build.build(*sources)
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} sources")
    for info in built.values():
        log(f"  nvcc {info['seconds']:.1f} s -> {info['path']}")
        log(info["log"].strip())
    t0 = time.perf_counter()
    for info in _build.build(*sources, ptx=True).values():
        log(f"  nvcc -ptx {info['seconds']:.1f} s -> {info['path']}")
    log(f"ptx: {time.perf_counter() - t0:.1f} s")

    worst = phase_small(dev)
    kernels = phase_full(dev, args.seed, args.scale, worst)
    # after phase 4: the analyzer's serving census leaves cuBLAS's
    # workspace allocated, which phase 4's peak device memory would count
    kernels += phase_analysis(dev)
    kernels.append(phase_flash(dev, args.seed))
    phase_serve(dev, args.seed)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
