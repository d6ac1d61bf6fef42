#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path on one NVIDIA card.

Run from the repository root, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py [--seed 0] [--scale 22]

Phases (any failure raises and exits non-zero):

1. Identity: the card's name, and its name and power limit from nvidia-smi.
2. Build: nvcc compiles ``src/repro_torch/kernels/skipper_match/csrc`` for
   sm_90a; the build time and ptxas report are printed.
3. Kernel against plain version, on the card, bit for bit: both kernels,
   ``skipper_match`` and ``skipper_match_window`` against the plain PyTorch
   versions of ``ref.py`` on the same CUDA tensors, under
   ``StateSpec.u8()`` and ``legacy_i32()`` and ``vector_rounds`` 1 and 2,
   on small schedules (RMAT scale 14, the pinned odd shapes, all-boundary,
   same-block pairs, an empty global tier, a star, a path, and a stream
   with duplicates and self-loops). Tolerance: exact equality.
4. Full scale: Graph500 RMAT (scale 22, edge factor 16) with window 65536,
   tile 256, degree reordering, uint8 state, one vector round. The main
   path runs once with the launch counts reset just before it; then the
   kernels and ``skipper_match`` are timed with CUDA events, each kernel is
   held bit for bit against its plain version on the same inputs, and the
   result must pass ``check_matching``, the state-domain check and the
   greedy certificate.
5. A ``{"kernels": [...]}`` line, the nvidia-smi line, and the last line
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

import numpy as np
import torch

# H100 SXM device-memory rate (NVIDIA data sheet), for the byte bound
HBM_BYTES_PER_S = 3.35e12
REPLACES = {
    "skipper_window_tier_kernel":
        "src/repro/kernels/skipper_match/kernel.py:158",
    "skipper_boundary_kernel":
        "src/repro/kernels/skipper_match/kernel.py:196",
}
SOURCE = "src/repro_torch/kernels/skipper_match/csrc/skipper_match.cu"


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
    log(f"phase 3 passed in {time.perf_counter() - t0:.1f} s")
    return worst


def window_bytes(s, spec) -> int:
    slots = s.u_tiles.size
    state = s.num_rows * s.window * spec.vmem_bytes
    return 8 * slots + 2 * state + 2 * spec.counter_bytes * slots


def boundary_bytes(s, spec) -> int:
    slots = s.num_boundary_padded
    state = s.num_windows * s.window * spec.vmem_bytes
    return (8 * s.num_boundary_tiles + 8 * slots + 2 * state
            + 2 * spec.counter_bytes * slots)


def phase_full(dev, seed: int, scale: int, worst):
    from repro_torch.core import check_matching, check_state_domain
    from repro_torch.core.statespec import StateSpec
    from repro_torch.graphs import build_window_schedule, rmat_graph
    from repro_torch.kernels.skipper_match import kernel, ref, skipper_match

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
        "skipper_window_tier_kernel": window_bytes(s, spec),
        "skipper_boundary_kernel": boundary_bytes(s, spec),
    }
    times = {"skipper_window_tier_kernel": (w_ms, wp_ms),
             "skipper_boundary_kernel": (b_ms, bp_ms)}
    return [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name][0],
         "plain_ms": times[name][1],
         "bound_ms": bounds[name] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None}
        for name in REPLACES
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the full-scale RMAT graph")
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale of the full-scale phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels.skipper_match import kernel

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(smi)

    info = kernel.build()
    log(f"build: nvcc {info['seconds']:.1f} s -> {info['path']}")
    log(info["log"].strip())

    worst = phase_small(dev)
    kernels = phase_full(dev, args.seed, args.scale, worst)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
