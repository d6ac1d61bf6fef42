#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's paths on one NVIDIA card.

Run from the repository root, with no arguments, on a machine with one
CUDA card:

    python3 chip_smoke.py [--seed 0] [--scale 22]

Phases (any failure raises and exits non-zero):

1. Identity: the card's name, and its name and power limit from nvidia-smi.
2. Build: one nvcc for each kernel source (``skipper_match.cu``,
   ``flash_attention.cu``, ``flash_attention_wgmma.cu``,
   ``flash_attention_tf32.cu`` and the analyzer's canaries ``mutants.cu``),
   all started together, for sm_90a, then their PTX the same way; the
   build times and ptxas reports are printed, and the PTX must hold the
   instructions the redesigned kernels are built from (``wgmma.mma_async``,
   in ``.tf32`` with ``cvt.rna.tf32`` in the three-term source, TMA with
   mbarrier completion, ``setmaxnreg``;
   bulk and 4-byte asynchronous copies, mbarrier waits; and in each
   instance of the asynchronous window tier its bulk copies in and out,
   its cp.async fills, its mbarrier waits, the proxy fence and the
   barrier-or of its dead-stage test).
3. Kernel against plain version, on the card, bit for bit: the window
   tiers (the asynchronous one and the first), the asynchronous global
   tier (the instance the shape picks, and its device-memory instance
   where that is another) and the first global tier, ``skipper_match``
   and ``skipper_match_window`` against the plain PyTorch versions of
   ``ref.py`` on the same CUDA tensors, under ``StateSpec.u8()`` and
   ``legacy_i32()`` and ``vector_rounds`` 1 and 2, on small schedules
   (RMAT scale 14, the pinned odd shapes, all-boundary, same-block pairs,
   an empty global tier, a star, a path, and a stream with duplicates and
   self-loops); ``skipper_match_window`` also against the first window
   tier on the same row. Tolerance: exact equality. On the RMAT scale-14
   schedule's first row, ``skipper_match_window`` (the window tier with
   one row) is also timed beside the first window tier, its plain version
   and bound.
4. Full scale: Graph500 RMAT (scale 22, edge factor 16) with window 65536,
   tile 256, degree reordering, uint8 state, one vector round. The main
   path runs once with the launch counts reset just before it (the
   asynchronous window tier and the asynchronous global tier, staged,
   must launch); then the kernels and ``skipper_match`` are timed with
   CUDA events, the window tiers in turns (first, asynchronous,
   asynchronous, first) with their time per tile, the global tiers in
   turns (first, asynchronous, asynchronous, first; then the
   device-memory instance) with theirs, and each asynchronous tier once
   more with its cycle profile on (where its loop spends its cycles),
   each held bit for bit against the one plain run of its tier on the
   same inputs, and the result must pass ``check_matching``, the
   state-domain check and the greedy certificate.
4b. The raw-stream matcher and the baselines, on phase 4's graph:
   ``skipper()`` (the global-tier kernel over one state row, every tile
   the pair (0, 0)) on the card bit for bit against its plain version on
   the CPU at four small streams (n = 257, RMAT 10, a star, a stream of
   duplicates, self-loops and invalid slots), tiles 32, 256, 512 and 1024
   (the last through ``skipper_boundary_kernel``), both layouts and both
   state widths, with conflicts and counters; then once on the RMAT graph
   as it comes (reorder none, tile 512, edges already on the card, their
   copy timed apart) with the launch counts reset just before it (the
   asynchronous global tier must launch once), held by
   ``check_matching``, the state-domain check and the greedy certificate
   in dispersed slot order, and timed warm end to end and as the kernel
   alone, with the Table II summary of its conflicts; ``ems_idmm``,
   ``ems_israeli_itai`` and ``sidmm`` (batch 4096) timed on the same
   graph and held valid and maximal (below the EMS round cap), and bit
   for bit against their CPU runs on RMAT 10 given the same
   permutations; the Fig. 7 line (accesses per edge) on RMAT scale 16,
   where the int32 counters cannot wrap, with the raw-stream kernel in
   both its instances (the main path's device-memory instance among them)
   held bit for bit against and timed beside its plain version on the
   card there; the
   APRAM oracle (``repro_torch.testing.pin_entry_points``) on masks from
   the card, RMAT scale 7, window 64, tile 32, all 13 rows (the
   distributed and chaos-recovered rows among them).
4c. The distributed matcher and the fault harness, on phase 4's graph.
   Small cases first: on two of phase 3's schedules, at both widths
   (``u8`` one vector round, ``legacy_i32`` two), ``distributed_skipper``
   (one rank, no process group) on both schedules, clean and under each
   fault site with ``on_fault="recover"``, and ``skipper_match`` under
   each site live at one rank, the kernels (``backend="cuda"``) bit for
   bit against the plain path on the same CUDA tensors (mask, state,
   counters, conflicts, every stats and report field). Then a one-rank
   NCCL group (``dist.get_backend() == "nccl"`` is asserted), and at full
   scale, each run with the launch counts reset just before it and timed
   with CUDA events and the host clock (rounds, ms a round, ``DistStats``):
   ``distributed_skipper`` on phase 4's schedule, equal to phase 4's
   ``skipper_match`` bit for bit (the window tier once and the global
   tier twice a round must launch); on the raw stream (dispersed), held
   by ``check_matching``, the state-domain check and the greedy
   certificate in stream order; ``skipper_match`` under
   ``FaultPlan(seed=7, drop_proposals=0.25, corrupt_state=0.05)``, whose
   ``"report"`` must see residual edges and corrupted cells and whose
   ``"recover"`` must be valid, maximal and clean; and
   ``distributed_skipper(on_fault="recover")`` with ``lose_shard=0`` and
   with ``truncate_retry=0``, each valid, maximal and clean. The block of
   the full-scale runs is ``DIST_BLOCK`` (PERF.md section 4). Each path's
   first slab pass is timed beside its plain version for the kernels line.
4a. Analysis (after 4c): the port's kernel conformance analyzer
   (``repro_torch.analysis``) over ``src/repro_torch`` and all 42 targets
   (each template instance of the three production kernels, and the
   ``skipper_match``, ``skipper``, ``flash_attention``, serving
   decode-step and both distributed entry points) must report no ERROR;
   each mutation canary must be caught by
   its named rule; the two canaries with plain versions
   (``swapped_writeback``, ``dynamic_gather``) must equal them bit for bit
   on the canonical schedule's global tier, where all three are timed. A
   JSON line gives the findings by rule and severity and each kernel's
   registers, shared memory and stack.
5. Flash attention: the kernel the entry point picks (the bf16
   tensor-core kernel for bf16 at D 64 and 128; the three-term TF32 kernel,
   after its pre-pass, for f32 and for bf16 at D 80) against its plain
   online-softmax version and against the model's chunked attention on
   the same CUDA inputs, in f32 and bf16, at granite-moe-3b-a800m's
   attention widths (S 128, 1024, 4096, causal; one non-causal case), at
   mixtral-8x7b's with its sliding window and at zamba2-2.7b's (Hq = Hkv =
   32, D = 80, S 4096); the pre-pass bit for bit against
   ``ref.tf32_planes``; in bf16 the CUDA-core kernel too (the yardstick),
   and the bf16 tensor-core kernel with P in one and in two bf16 terms,
   whose misses of the one-step criterion are counted (not held). The
   zamba2 case is timed in both dtypes beside the CUDA-core kernel. Then
   the path, the ``flash_attention`` entry point at granite's prefill_32k
   attention shape in bf16 and in f32 (inputs drawn in f32: upcast bf16
   values are exact in TF32 and would never exercise the lo terms), once
   with the launch counts reset just before it (the CUDA-core kernel must
   not launch), and the kernels (the three-term one alone on its planes,
   its pre-pass alone, and whole), the CUDA-core kernel, the plain
   version and ``scaled_dot_product_attention`` timed there in both
   dtypes (in f32 through its memory-efficient backend, on K and V
   repeated to the query heads: its GQA form runs only in the flash and
   math backends, and the math one would hold the 32K-square scores); the
   kernels and f32 SDPA are held against the plain version at that shape
   too (2e-5 in f32).
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
6b. The ssm, hybrid, audio and vlm families (no kernel of the port is on
   their paths, as no Pallas kernel is on the JAX package's: the launch
   counts, reset before (b), must stay 0). (a) The smoke configs of
   mamba2-130m, zamba2-2.7b, whisper-large-v3 and qwen2-vl-2b in f32,
   weights drawn on a CPU generator and copied to the card: prefill logits
   and every cache tensor, then three decode steps (vlm with an image
   prefix of 16 on a 4x4 grid, audio with its encoder frames), on the card
   against the port's CPU path within 1e-4 of each tensor's largest
   magnitude. (b) Full width and depth, bf16, seeded weights: mamba2-130m
   and zamba2-2.7b through ``serve`` (4 requests on 2 slots, prompts of
   512, 16 new tokens, twice: the first run's logits finite, request 0's
   tokens the same in both); qwen2-vl-2b (1,024 image tokens on the 32x32
   grid and 512 text tokens) and whisper-large-v3 (1,500 frames and a
   64-token prompt) through ``adapters.prefill_fn`` and 16 greedy
   ``decode_fn`` steps, every logit finite; prefill ms, decode tokens/s,
   peak device memory, and one decode step traced with
   ``torch.profiler``. (c) The SSD duality at full width in f32:
   token-by-token decode from an empty cache against the chunked forward
   on the same tokens (mamba2-130m 128, zamba2-2.7b 64), within 2e-2 (the
   reference's bound). A ``family serving metrics:`` line.
7. Training. (a) One f32 ``train_step`` of the llama3.2-1b, granite-moe,
   mamba2, zamba2, whisper and qwen2-vl smoke configs on the card against
   the port's CPU step on the same weights and batch: loss and grad norm
   within 1e-4 relative,
   the moments within 1e-4, each parameter within 1e-4 plus what a
   gradient error of 1e-4 moves AdamW's first update. (c)
   granite-moe-3b-a800m at full width and depth (bf16, Skipper router,
   remat, seed 0, learning rate 1e-4) trains 3 steps through the train
   path's ``TrainConfig``, step function and batches, as
   ``python -m repro_torch.launch.train --arch granite-moe-3b-a800m
   --steps 3 --batch 2 --seq 2048 --lr 1e-4`` runs them
   (``DataConfig(seq_len=2048, batch_per_host=2)``: 4,096 packed
   tokens a step, one routing group), the launch counts reset just
   before (the packer's global-tier kernel must launch once a step): the
   loss and grad norm finite at every step, the last loss below the
   first, and at the first step ``chunked_ce`` within 1e-3 of
   ``cross_entropy`` on the whole logits of the same forward; step ms
   (host clock ending in a sync), tokens/s, ``bmatch_assign``'s share of
   a step (CUDA event pairs), peak device memory, and the last step
   traced with ``torch.profiler``. (b) At every step the card's packed
   rows equal the CPU packer's, and the step's global-tier launch equals
   ``ref.ref_skipper`` on the same tiles bit for bit (mask, state,
   conflicts). (d) granite at full width and 2 layers: two steps, an
   asynchronous save, a restore into a fresh model (parameters and both
   moments bit-equal to the live ones), and the next step from both
   (loss within 1e-4). (e) The packer's kernel timed beside
   ``ref_skipper`` on the last step's tiles for the kernels line.
8. The sharding layer (``repro_torch.parallel``, ``launch.mesh``,
   ``launch.dryrun``). (a) The dry-run reckons every runnable cell on the
   16x16 and 2x16x16 meshes (a line a cell; none may fail; the counts
   that fit the card's memory in the reference's layout and in the
   port's own step). (b) The smoke configs of llama3-405b and
   qwen1.5-110b, card against CPU at 1e-4 as in 6b(a). (c) Both at full
   width cut to SHARD_LAYERS layers (bf16, seeded weights) through
   ``serve``: one request, a 512-token prompt, 8 new tokens, every logit
   finite. (d) One qwen1.5-110b training step at that depth, 1 x 2048,
   bf16 moments as its config says, through ``launch.train.train``:
   first without a process group, then under ``make_host_mesh()`` on a
   one-rank NCCL group (parameters and moments held as ``param_specs``
   slices them, the loss the all-reduced global mean), the launch
   counts reset just before (the packer's global tier must launch);
   loss finite, and the sharded loss and every updated parameter within
   one bf16 step of the unsharded ones (the largest difference printed).
   A ``sharding metrics:`` line with the times, peak device bytes and
   cells, the nvidia-smi line beside it.
9. A ``{"kernels": [...]}`` line (the canaries with ``"status":
   "canary"``), the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when CUDA is unavailable or the
port's sources are missing.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
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
    "skipper_window_async_kernel":
        "src/repro/kernels/skipper_match/kernel.py:158",
    "skipper_boundary_kernel":
        "src/repro/kernels/skipper_match/kernel.py:196",
    "skipper_boundary_async_kernel":
        "src/repro/kernels/skipper_match/kernel.py:196",
    "flash_attention_kernel":
        "src/repro/kernels/flash_attention/kernel.py:28",
    "flash_attention_wgmma_kernel":
        "src/repro/kernels/flash_attention/kernel.py:28",
    "flash_attention_tf32x3_kernel":
        "src/repro/kernels/flash_attention/kernel.py:28",
    "flash_split_tf32_kernel":
        "src/repro/kernels/flash_attention/kernel.py:28",
}
SOURCE = "src/repro_torch/kernels/skipper_match/csrc/skipper_match.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_WGMMA_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_wgmma.cu")
FLASH_TF32_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention_tf32.cu")
WINDOW, WINDOW_ASYNC, BOUNDARY, ASYNC = ("skipper_window_tier_kernel",
                                         "skipper_window_async_kernel",
                                         "skipper_boundary_kernel",
                                         "skipper_boundary_async_kernel")
MUTANT_SOURCE = "src/repro_torch/analysis/csrc/mutants.cu"
#: the analyzer's targets: 40 kernel instances and 6 entry points
ANALYSIS_TARGETS = 46


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptx_entries(text: str, name: str):
    """The bodies of the PTX entry functions whose mangled name holds
    ``name``, each from its ``.entry`` line to the next one."""
    parts = re.split(r"^(?=(?:\.visible\s+|\.weak\s+)?\.entry\s)", text,
                     flags=re.M)
    return [p for p in parts if p.lstrip().startswith((".entry", ".visible",
                                                       ".weak"))
            and name in p.split("(", 1)[0]]


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


def slot_certificate(su: torch.Tensor, sv: torch.Tensor,
                     stream: torch.Tensor, mask: torch.Tensor, n: int,
                     where: str = "certificate") -> None:
    """Exact O(E) proof that ``mask`` (stream order) equals the sequential
    greedy matching over a slot order: slot p holds vertex ids ``su[p]``,
    ``sv[p]`` and stream index ``stream[p]`` (-1: padding). The matching is
    valid, no edge outside a valid slot is matched, and every valid
    unmatched slot p has an endpoint whose first matched slot lies before
    p."""
    real = (stream >= 0) & (su >= 0) & (su != sv)
    taken = torch.zeros_like(real)
    taken[real] = mask[stream[real]]
    in_slots = torch.zeros_like(mask)
    in_slots[stream[real]] = True
    require(not bool(mask[~in_slots].any()),
            f"{where}: an edge outside the valid slots is matched")
    ends = torch.cat([su[taken], sv[taken]])
    require(bool((torch.bincount(ends, minlength=n) <= 1).all()),
            f"{where}: two matched slots share a vertex")
    pos = torch.arange(su.numel(), device=su.device)
    first = torch.full((n,), su.numel(), dtype=torch.long, device=su.device)
    first = first.scatter_reduce(0, ends, pos[taken].repeat(2), "amin")
    open_ = real & ~taken
    earlier = torch.minimum(first[su[open_]], first[sv[open_]])
    require(bool((earlier < pos[open_]).all()),
            f"{where}: a valid unmatched slot has no endpoint matched "
            "earlier in slot order")


def greedy_certificate(schedule, mask: torch.Tensor) -> None:
    """:func:`slot_certificate` over the schedule's slot order (window
    rows, then global-tier slots), in its renumbered vertex ids."""
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
    slot_certificate(su, sv, stream, mask, s.num_windows * s.window)


def stream_certificate(ut: torch.Tensor, vt: torch.Tensor,
                       mask: torch.Tensor, n: int) -> None:
    """:func:`slot_certificate` over a raw stream's tiles in slot order
    ``t * T + l``, with the dispersed layout's stream index
    ``l * num_tiles + t``: the raw-stream matcher equals the sequential
    greedy over its tiles in lane order."""
    num_tiles, tile = ut.shape
    t = torch.arange(num_tiles, device=ut.device)[:, None]
    lane = torch.arange(tile, device=ut.device)[None, :]
    stream = (lane * num_tiles + t).reshape(-1)
    stream = torch.where(stream < mask.numel(), stream, -1)
    slot_certificate(ut.reshape(-1).long(), vt.reshape(-1).long(), stream,
                     mask, n, "raw-stream certificate")


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
    """The tier kernels against their plain versions on the same CUDA
    inputs: the window tiers (the asynchronous one, which every phase-3
    shape takes, and the first), the asynchronous global tier (the instance the shape picks, and
    the device-memory one when that is not it) and the first global tier.
    Returns the max_abs_err of each, by kernel name."""
    from repro_torch.kernels.skipper_match import kernel, ref

    x = tier_inputs(s, dev)
    state0 = torch.zeros((s.num_rows, s.window), dtype=spec.vmem_dtype,
                         device=dev)
    kw = dict(tile_size=s.tile_size, vector_rounds=vr, spec=spec)
    p_out = ref.ref_window_tier(x["u2"], x["v2"], state0, **kw)
    errs = {WINDOW: 0, WINDOW_ASYNC: 0, BOUNDARY: 0, ASYNC: 0}
    for name, fn in ((WINDOW_ASYNC, kernel.window_tier),
                     (WINDOW, kernel.window_tier_sync)):
        k_out = fn(x["u2"], x["v2"], state0, **kw)
        torch.cuda.synchronize()
        errs[name] = max(errs[name], max_err(*zip(k_out, p_out)))
    flat = torch.zeros((s.num_windows, s.window), dtype=spec.vmem_dtype,
                       device=dev)
    flat[x["rows"]] = p_out[0]
    if s.num_boundary_tiles:
        args = (x["blk_u"], x["blk_v"], x["bu"], x["bv"])
        fp = flat.clone()
        pb = ref.ref_boundary_pass(fp, *args, vector_rounds=vr, spec=spec)
        runs = [(ASYNC, kernel.boundary_tier, {}),
                (BOUNDARY, kernel.boundary_tier_sync, {})]
        if kernel.boundary_instance(s.window, s.tile_size, spec) != "device":
            runs.append((ASYNC, kernel.boundary_tier, {"instance": "device"}))
        for name, fn, extra in runs:
            fk = flat.clone()
            kb = fn(fk, *args, vector_rounds=vr, spec=spec, **extra)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], max_err((fk, fp), *zip(kb, pb)))
    return errs


def compare_match(edges, s, spec, vr, dev):
    """skipper_match and skipper_match_window, kernels against plain;
    skipper_match_window also against the first window tier."""
    from repro_torch.core import check_matching, check_state_domain
    from repro_torch.kernels.skipper_match import (
        kernel, skipper_match, skipper_match_window)

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
                              spec=spec, device=dev)
    wp = skipper_match_window(u, v, st0, s.tile_size, vr, backend="torch",
                              spec=spec, device=dev)
    first = kernel.window_tier_sync(
        u.reshape(1, -1), v.reshape(1, -1),
        st0.to(spec.vmem_dtype).reshape(1, -1), tile_size=s.tile_size,
        vector_rounds=vr, spec=spec)
    torch.cuda.synchronize()
    return max(err, max_err(*zip(wk, wp)),
               max_err(*zip(wp, (t[0] for t in first))))


def phase_small(dev):
    from repro_torch.core.statespec import StateSpec
    from repro_torch.graphs import build_window_schedule

    from repro_torch.kernels.skipper_match import kernel

    worst = {WINDOW: 0, WINDOW_ASYNC: 0, BOUNDARY: 0, ASYNC: 0}
    t0 = time.perf_counter()
    for label, edges, window, tile, reorder in small_cases():
        s = build_window_schedule(edges, window, tile, reorder=reorder)
        for spec_name in ("u8", "legacy_i32"):
            spec = getattr(StateSpec, spec_name)()
            require(kernel.window_instance(window, tile, spec) == "async",
                    f"{label}/{spec_name}: the shape does not take the "
                    "asynchronous window tier")
            for vr in (1, 2):
                errs = compare_tiers(s, spec, vr, dev)
                err_m = compare_match(edges, s, spec, vr, dev)
                log(f"  {label:>18} {spec_name:>10} rounds={vr} "
                    f"rows={s.num_rows}x{s.tiles_per_window} "
                    f"ring={kernel.window_ring_stages(window, tile, spec)} "
                    f"global_tiles={s.num_boundary_tiles} "
                    f"{kernel.boundary_instance(window, tile, spec)} "
                    f"err window={errs[WINDOW_ASYNC]} "
                    f"first_window={errs[WINDOW]} global={errs[ASYNC]} "
                    f"first_global={errs[BOUNDARY]} match={err_m}")
                require(max(errs.values()) == 0 and err_m == 0,
                        f"{label}/{spec_name}/rounds={vr}: kernel and plain "
                        "version disagree")
                for name in (WINDOW_ASYNC, ASYNC):  # on skipper_match
                    worst[name] = max(worst[name], errs[name], err_m)
                for name in (WINDOW, BOUNDARY):
                    worst[name] = max(worst[name], errs[name])
        if label == "rmat14":
            time_match_window(s, dev)
    log(f"phase 3 passed in {time.perf_counter() - t0:.1f} s")
    return worst


def time_match_window(s, dev) -> None:
    """``skipper_match_window`` (the window tier launched with one row, the
    port of ``skipper_window_kernel``) on the schedule's first row from an
    all-ACC state, u8, one vector round: launches on its path, its time
    and the first window tier's in turns (first, new, new, first), the
    plain time, and the byte bound (ids in, state in and out, matched and
    conflicts out)."""
    from repro_torch.kernels.skipper_match import kernel, skipper_match_window
    from repro_torch.roofline import h100

    u, v = put(s.u_tiles[0], dev), put(s.v_tiles[0], dev)
    st0 = torch.zeros(s.window, dtype=torch.uint8, device=dev)
    kernel.reset_launch_counts()
    skipper_match_window(u, v, st0, s.tile_size, 1)
    torch.cuda.synchronize()
    launches = kernel.launch_counts()
    require(launches[WINDOW_ASYNC] == 1 and launches[WINDOW] == 0,
            f"skipper_match_window launched {launches}")
    plain_ms, want = cuda_time(lambda: skipper_match_window(
        u, v, st0, s.tile_size, 1, backend="torch", device=dev))
    runs = {
        WINDOW: lambda: tuple(t[0] for t in kernel.window_tier_sync(
            u.reshape(1, -1), v.reshape(1, -1), st0.reshape(1, -1),
            tile_size=s.tile_size)),
        WINDOW_ASYNC: lambda: skipper_match_window(
            u, v, st0, s.tile_size, 1, backend="cuda", device=dev)}
    times, err = {WINDOW: [], WINDOW_ASYNC: []}, 0
    for name in (WINDOW, WINDOW_ASYNC, WINDOW_ASYNC, WINDOW):
        ms, got = cuda_time(runs[name], reps=3)
        times[name].append(ms)
        err = max(err, max_err(*zip(got, want)))
    require(err == 0, "skipper_match_window: a kernel and plain disagree")
    nbytes = 8 * u.numel() + 2 * s.window + 2 * u.numel()
    log("skipper_match_window metrics: " + json.dumps({
        "schedule": f"rmat14 row 0, window {s.window}, "
                    f"{s.tiles_per_window} tiles of {s.tile_size}",
        "launches_on_path": launches[WINDOW_ASYNC],
        "kernel_ms": min(times[WINDOW_ASYNC]),
        "first_kernel_ms": min(times[WINDOW]), "turns_ms": times,
        "plain_ms": plain_ms, "bound_ms": h100.bytes_ms(nbytes),
        "bound_by": "bytes", "max_abs_err": err}))


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
    require(launches[WINDOW_ASYNC] > 0 and launches[ASYNC] > 0,
            f"a kernel of the main path was not launched: {launches}")
    require(kernel.window_instance(window, tile, spec) == "async",
            "the full-scale window tier is not the asynchronous kernel")
    require(kernel.boundary_instance(window, tile, spec) == "staged",
            "the full-scale global tier is not the staged instance")

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
    wp_ms, wp_out = cuda_time(
        lambda: ref.ref_window_tier(x["u2"], x["v2"], state0, **kw))
    # the window tiers in turns (first, async, async, first), each held
    # bit for bit against the one plain run
    w_fns = {WINDOW: kernel.window_tier_sync, WINDOW_ASYNC: kernel.window_tier}
    w_times, err_w = {WINDOW: [], WINDOW_ASYNC: []}, {WINDOW: 0,
                                                     WINDOW_ASYNC: 0}
    for name in (WINDOW, WINDOW_ASYNC, WINDOW_ASYNC, WINDOW):
        ms, w_out = cuda_time(lambda: w_fns[name](x["u2"], x["v2"], state0,
                                                  **kw))
        w_times[name].append(ms)
        err_w[name] = max(err_w[name], max_err(*zip(w_out, wp_out)))
        del w_out
    w_ms = {name: min(t) for name, t in w_times.items()}
    nw = s.num_rows * s.tiles_per_window
    for name, ms in w_ms.items():
        log(f"window tier {name}: {ms:.3f} ms ({w_times[name]}), "
            f"{1e3 * ms / nw:.4f} us a tile over {nw} tiles, max_abs_err "
            f"against plain {err_w[name]}")
    log(f"window tier plain: {wp_ms:.1f} ms")
    # once more with the asynchronous window tier's cycle profile on
    # (thread 0's clock64 spans over the stage loop), also held against the
    # plain version
    wprof = torch.zeros(len(kernel.WINDOW_PROFILE_FIELDS), dtype=torch.int64,
                        device=dev)
    wprof_ms, w_out = cuda_time(lambda: kernel.window_tier(
        x["u2"], x["v2"], state0, **kw, profile=wprof))
    err_w["profiled"] = max_err(*zip(w_out, wp_out))
    del w_out
    wc = dict(zip(kernel.WINDOW_PROFILE_FIELDS, wprof.tolist()))
    stages_run = -(-s.tiles_per_window // kernel.WINDOW_STAGE_TILES) \
        * s.num_rows
    window_profile = {
        "profiled_ms": wprof_ms,
        "cycles_per_us": wc["total"] / (wprof_ms * 1e3),
        "ring_stages": kernel.window_ring_stages(window, tile, spec),
        "stage_tiles": kernel.WINDOW_STAGE_TILES, "stages": stages_run,
        **{f"{f}_cycles_per_tile": wc[f] / nw for f in
           ("stage_wait", "dead_test", "tile_mask", "tile_body",
            "counters_release_refill", "refill", "total")},
        "dead_stages": wc["dead_stages"],
        "dead_stage_share": wc["dead_stages"] / stages_run,
        "walked_tiles": wc["walked_tiles"],
        "free_tiles": wc["free_tiles"],
        "free_tile_share": wc["free_tiles"] / nw,
        "tile_body_cycles_per_walked_tile": wc["tile_body"]
        / max(wc["walked_tiles"], 1),
        "tile_body_cycles_per_free_tile": wc["tile_body_in_free_tiles"]
        / max(wc["free_tiles"], 1),
        "stage_cycles_per_stage": (wc["stage_wait"] + wc["dead_test"]
                                   + wc["counters_release_refill"])
        / stages_run,
        "cycles": wc,
    }
    log("window tier profile: " + json.dumps(window_profile))
    flat = torch.zeros((s.num_windows, window), dtype=spec.vmem_dtype,
                       device=dev)
    flat[x["rows"]] = wp_out[0]
    args = (x["blk_u"], x["blk_v"], x["bu"], x["bv"])
    fp = flat.clone()
    bp_ms, bp_out = cuda_time(lambda: ref.ref_boundary_pass(
        fp, *args, vector_rounds=vr, spec=spec))
    plain = (fp, *bp_out)
    # the global tiers in turns (first, async, async, first), each held
    # bit for bit against the plain version and so against each other;
    # the device-memory instance of the asynchronous tier once
    runs = [(BOUNDARY, kernel.boundary_tier_sync, {}),
            (ASYNC, kernel.boundary_tier, {}), (ASYNC, kernel.boundary_tier, {}),
            (BOUNDARY, kernel.boundary_tier_sync, {}),
            ("device instance", kernel.boundary_tier, {"instance": "device"})]
    g_times, err_b = {}, {BOUNDARY: 0, ASYNC: 0, "device instance": 0}
    for name, fn, extra in runs:
        fk = flat.clone()
        ms, b_out = cuda_time(lambda: fn(fk, *args, vector_rounds=vr,
                                         spec=spec, **extra))
        g_times.setdefault(name, []).append(ms)
        err_b[name] = max(err_b[name], max_err(*zip((fk, *b_out), plain)))
    nb = s.num_boundary_tiles
    b_ms = {name: min(t) for name, t in g_times.items()}
    for name, ms in b_ms.items():
        log(f"global tier {name}: {ms:.3f} ms ({g_times[name]}), "
            f"{1e3 * ms / nb:.4f} us a tile over {nb} tiles, "
            f"max_abs_err against plain {err_b[name]}")
    log(f"global tier plain: {bp_ms:.1f} ms")
    # one more run of each instance with the kernel's cycle profile on
    # (thread 0's clock64 spans over the tile loop, and its counts), also
    # held against the plain version
    tile_profiles = {}
    for instance in kernel.INSTANCES:
        prof = torch.zeros(len(kernel.PROFILE_FIELDS), dtype=torch.int64,
                           device=dev)
        fk = flat.clone()
        prof_ms, b_out = cuda_time(lambda: kernel.boundary_tier(
            fk, *args, vector_rounds=vr, spec=spec, instance=instance,
            profile=prof))
        err_b[f"profiled {instance}"] = max_err(*zip((fk, *b_out), plain))
        cyc = dict(zip(kernel.PROFILE_FIELDS, prof.tolist()))
        free = max(cyc["free_tiles"], 1)
        tile_profiles[instance] = {
            "profiled_ms": prof_ms,
            "cycles_per_us": cyc["total"] / (prof_ms * 1e3),
            **{f"{f}_cycles_per_tile": cyc[f] / nb for f in
               ("wait_and_ids", "state_rows", "tile_body",
                "counters_release_refill", "total")},
            "free_tile_share": cyc["free_tiles"] / nb,
            "tile_body_cycles_in_free_tiles": cyc["tile_body_in_free_tiles"]
            / free,
            "tile_body_cycles_in_other_tiles": (
                cyc["tile_body"] - cyc["tile_body_in_free_tiles"])
            / max(nb - cyc["free_tiles"], 1),
            "free_rounds_per_free_tile": cyc["free_rounds"] / free,
            "stale_lanes_per_tile": cyc["stale_lanes"] / nb,
            "later_round_tile_share": cyc["later_round_tiles"] / nb,
        }
        log(f"global tier profile ({instance}): "
            + json.dumps(tile_profiles[instance]))
    tile_profile = tile_profiles[kernel.boundary_instance(window, tile,
                                                          spec)]
    require(max(err_w.values()) == 0 and max(err_b.values()) == 0,
            "full scale: a kernel and its plain version disagree")
    worst[WINDOW] = max(worst[WINDOW], err_w[WINDOW])
    worst[WINDOW_ASYNC] = max(worst[WINDOW_ASYNC], err_w[WINDOW_ASYNC],
                              err_w["profiled"])
    worst[ASYNC] = max(worst[ASYNC], err_b[ASYNC], err_b["device instance"],
                       err_b["profiled staged"], err_b["profiled device"])
    worst[BOUNDARY] = max(worst[BOUNDARY], err_b[BOUNDARY])

    metrics = {
        "skipper_match_ms_events": match_ms,
        "skipper_match_wall_s": wall_s,
        "medges_per_s": s.num_valid / (match_ms * 1e-3) / 1e6,
        "window_tier_ms": w_ms[WINDOW_ASYNC],
        "window_tier_us_per_tile": 1e3 * w_ms[WINDOW_ASYNC] / nw,
        "first_window_tier_ms": w_ms[WINDOW],
        "first_window_tier_us_per_tile": 1e3 * w_ms[WINDOW] / nw,
        "window_tier_speedup": w_ms[WINDOW] / w_ms[WINDOW_ASYNC],
        "window_tier_profile": window_profile,
        "global_tier_ms": b_ms[ASYNC],
        "global_tier_us_per_tile": 1e3 * b_ms[ASYNC] / nb,
        "first_global_tier_ms": b_ms[BOUNDARY],
        "first_global_tier_us_per_tile": 1e3 * b_ms[BOUNDARY] / nb,
        "device_instance_ms": b_ms["device instance"],
        "global_tier_speedup": b_ms[BOUNDARY] / b_ms[ASYNC],
        "global_tier_profile": tile_profile,
        "global_tier_device_profile": tile_profiles["device"],
        "schedule_copy_ms": copy_ms,
        "peak_device_bytes": peak,
    }
    log("full-scale metrics: " + json.dumps(metrics))
    log("bound_ms counts the bytes each kernel must move at 3.35 TB/s; the "
        "serial chain of tiles in one block, not bytes, limits all four")
    bounds = {WINDOW: h100.window_bytes(s, spec),
              WINDOW_ASYNC: h100.window_bytes(s, spec),
              BOUNDARY: h100.boundary_bytes(s, spec),
              ASYNC: h100.boundary_bytes(s, spec)}
    times = {WINDOW: (w_ms[WINDOW], wp_ms),
             WINDOW_ASYNC: (w_ms[WINDOW_ASYNC], wp_ms),
             BOUNDARY: (b_ms[BOUNDARY], bp_ms), ASYNC: (b_ms[ASYNC], bp_ms)}
    entries = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name][0],
         "plain_ms": times[name][1],
         "bound_ms": h100.bytes_ms(bounds[name]),
         "bound_by": "bytes", "library_ms": None}
        for name in (WINDOW_ASYNC, ASYNC, WINDOW, BOUNDARY)]
    # the first tiers left the main path: the yardsticks of their
    # replacements, and the bodies the analyzer's canaries copy
    for e in entries[2:]:
        e["status"] = "superseded"
    phase4 = {"schedule": s, "result": res, "match_ms": match_ms,
              "window_entry": dict(entries[0])}
    return entries, edges, phase4


# --------------------------------------------------------------- phase 4b --
#: the raw-stream matcher's tiles in phase 4b's small cases: the last one
#: takes skipper_boundary_kernel (over kernel.BOUNDARY_ASYNC_MAX_THREADS)
RAW_TILES = (32, 256, 512, 1024)
RAW_TILE = 512
#: the Fig. 7 line's graph: small enough that no counter wraps in int32
ACCESS_SCALE = 16
SIDMM_BATCH = 4096
INT32_LIMIT = 2**31


def raw_cases():
    """(label, edges) of phase 4b's small raw streams: n = 257 (a row of no
    whole 16-byte units: the device-memory instance), RMAT scale 10 (n =
    1024: the staged instance), a star, and a stream with duplicates,
    self-loops, padding and half-invalid slots (-1, v)."""
    from repro_torch.graphs import path_graph, rmat_graph, star_graph
    from repro_torch.interop import edges_from_arrays

    hz = random_stream(21, 300, 1500, dup=0.1, loops=0.1, invalid=0.05)
    u = hz.u.numpy().copy()
    u[np.random.default_rng(22).random(u.shape[0]) < 0.03] = -1
    return [("path257", path_graph(257)),
            ("rmat10", rmat_graph(10, 8, seed=2)),
            ("star600", star_graph(600)),
            ("hazards", edges_from_arrays(u, hz.v.numpy(), 300))]


def match_err(got, want) -> int:
    """max_abs_err of two ``skipper`` results: mask, state, conflicts and
    the four counters (``want`` may lie on the CPU)."""
    (r, c), (rp, cp) = got, want
    pairs = [(r.match_mask, rp.match_mask), (r.state, rp.state)]
    if c is not None or cp is not None:
        pairs.append((c, cp))
    for f in ("edge_reads", "state_loads", "state_stores", "rounds"):
        pairs.append((getattr(r.counters, f), getattr(rp.counters, f)))
    return max_err(*((a.cpu(), b.cpu()) for a, b in pairs))


def raw_small(dev):
    """``skipper`` on the card against its plain version on the CPU, bit
    for bit, at every small case, tile, layout and state width, with
    conflicts. Returns the worst max_abs_err."""
    from repro_torch.core import skipper
    from repro_torch.core.statespec import StateSpec

    worst, t0 = 0, time.perf_counter()
    for label, g in raw_cases():
        errs = []
        for tile in RAW_TILES:
            for dispersed in (True, False):
                for spec_name in ("u8", "legacy_i32"):
                    kw = dict(tile_size=tile, dispersed=dispersed,
                              with_conflicts=True, vector_rounds=2,
                              spec=getattr(StateSpec, spec_name)())
                    err = match_err(skipper(g, device=dev, **kw),
                                    skipper(g, device="cpu", **kw))
                    errs.append(err)
                    require(err == 0, f"raw stream {label} tile {tile} "
                            f"dispersed={dispersed} {spec_name}: the card "
                            f"and the plain version disagree ({err})")
        worst = max(worst, *errs)
        log(f"  raw {label:>8} n={g.num_vertices} m={g.num_edges}: "
            f"{len(errs)} cases bit-equal (tiles {RAW_TILES}, both "
            "layouts, both widths)")
    log(f"raw-stream small cases: {time.perf_counter() - t0:.1f} s")
    return worst


def raw_kernel(ut, vt, n: int, instance: str):
    """The raw-stream kernel alone, as ``skipper()`` runs it
    (``kernel.tiles_on_card``): ``boundary_tier`` in ``instance`` on a
    fresh row at the default widths, every tile the pair (0, 0). Returns
    ``(state, matched, conflicts int32)``."""
    from repro_torch.kernels.skipper_match import kernel

    row = torch.zeros((1, n), dtype=torch.uint8, device=ut.device)
    pairs = torch.zeros(ut.shape[0], dtype=torch.int32, device=ut.device)
    matched, conflicts = kernel.boundary_tier(row, pairs, pairs, ut, vt,
                                              instance=instance)
    return row[0], matched > 0, conflicts.to(torch.int32)


def accesses_line(dev, seed: int, tile: int, instance: str):
    """The Fig. 7 analogue: memory accesses per edge of Skipper and the
    three baselines on RMAT scale ACCESS_SCALE, printed only where no
    int32 counter can have wrapped (rounds x the most a round adds stays
    below 2^31). Also the raw-stream kernel in each of its instances (the
    filtered one too) against its plain version on the card there, bit for
    bit and timed: the plain
    time of the kernels line, and the kernel's time there in the main
    path's ``instance``. Returns ``(plain_ms, kernel_ms, max_abs_err,
    case)``."""
    from repro_torch.core import ems_idmm, ems_israeli_itai, sidmm, skipper
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels.skipper_match import kernel, ref

    g = rmat_graph(ACCESS_SCALE, 16, seed=seed).to(dev)
    n, m = g.num_vertices, g.num_edges
    ut, vt = stream_tiles(g, tile)

    def plain():
        st = torch.zeros(n, dtype=torch.uint8, device=dev)
        return (st, *ref.ref_skipper(st, ut, vt))

    plain_ms, want = cuda_time(plain)
    err, k_ms = 0, {}
    for inst in kernel.INSTANCES + (kernel.FILTERED,):
        k_ms[inst], got = cuda_time(
            lambda inst=inst: raw_kernel(ut, vt, n, inst),
            reps=3)
        e = max_err(*zip(got, want))
        require(e == 0, f"raw stream RMAT {ACCESS_SCALE}, {inst} instance: "
                f"kernel and plain version disagree ({e})")
        err = max(err, e)
    log(f"raw stream RMAT {ACCESS_SCALE} ({ut.shape[0]} tiles of {tile}): "
        f"every instance bit-equal to ref_skipper ({plain_ms:.1f} ms); "
        f"kernel ms {json.dumps(k_ms)}")
    # (run, the most one round adds to the counters' total, the most added
    # once)
    runs = {
        "skipper": (lambda: skipper(g, tile_size=tile, device=dev)[0],
                    6 * m, 0),
        "ems_idmm": (lambda: ems_idmm(g, device=dev), 11 * m, 0),
        "ems_israeli_itai": (
            lambda: ems_israeli_itai(g, seed=seed, device=dev), 13 * m, 0),
        "sidmm": (lambda: sidmm(g, batch_size=SIDMM_BATCH, seed=seed,
                                device=dev),
                  11 * SIDMM_BATCH, 2 * (-(-m // SIDMM_BATCH)) * SIDMM_BATCH),
    }
    per_edge = {}
    for name, (run, per_round, once) in runs.items():
        r = run()
        rounds = int(r.counters.rounds)
        most = once + rounds * per_round
        per_edge[name] = (int(r.counters.total_accesses) / m
                          if most < INT32_LIMIT else
                          f"not printed: up to {most} accesses wrap int32")
    log("accesses per edge (Fig. 7 analogue): " + json.dumps({
        "graph": f"RMAT scale {ACCESS_SCALE}, edge factor 16, seed {seed}",
        "edges": m, "per_edge": per_edge}))
    case = (f"ref_skipper on the card, RMAT scale {ACCESS_SCALE} "
            f"({ut.shape[0]} tiles of {tile}), bit-equal to the {instance} "
            "instance")
    return plain_ms, k_ms[instance], err, case


def phase_raw(dev, edges, seed: int, match_ms: float):
    """Phase 4b: the raw-stream matcher ``skipper()`` through the global
    tier kernel, and the paper's baselines, on phase 4's graph; the APRAM
    oracle on masks from the card. Returns the kernels line's entry."""
    from repro_torch.core import (
        check_matching, check_state_domain, conflict_table, ems_idmm,
        ems_israeli_itai, sidmm, skipper)
    from repro_torch.core.ems import MAX_ROUNDS
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.core.statespec import DEFAULT
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels.skipper_match import kernel
    from repro_torch.roofline import h100
    from repro_torch.testing import pin_entry_points

    t_phase = time.perf_counter()
    worst = raw_small(dev)

    # the main path: rmat22 raw, reorder none, device-resident edges
    copy_ms, g = cuda_time(lambda: edges.to(dev))
    n, m = g.num_vertices, g.num_edges
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    res, conf = skipper(g, tile_size=RAW_TILE, with_conflicts=True,
                        device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = kernel.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"raw-stream main path: {first_s:.3f} s (first call), launches "
        f"{launches}, peak device memory {peak} B")
    require(launches[ASYNC] == 1 and sum(launches.values()) == 1,
            f"skipper did not go through {ASYNC} once: {launches}")
    chk = check_matching(g, res.match_mask)
    require(bool(chk["valid"]) and bool(chk["maximal"]),
            f"raw stream: check_matching failed {chk}")
    require(bool(check_state_domain(res.state)["clean"]),
            "raw stream: state domain")
    ut, vt = stream_tiles(g, RAW_TILE)
    stream_certificate(ut, vt, res.match_mask, n)
    table = conflict_table(conf.cpu())
    log(f"raw stream: valid maximal matching of {int(chk['num_matches'])} "
        "edges, state clean, greedy certificate in dispersed slot order "
        "holds")

    # warm: end to end, then the kernel alone on the same tiles
    sk_ms, _ = cuda_time(lambda: skipper(g, tile_size=RAW_TILE, device=dev),
                         reps=3)
    num_tiles = ut.shape[0]
    instance = (kernel.FILTERED
                if kernel.takes_filtered(num_tiles, RAW_TILE, dev)
                else kernel.boundary_instance(n, RAW_TILE))
    k_ms, k_out = cuda_time(
        lambda: raw_kernel(ut, vt, n, instance), reps=3)
    want = (res.state, res.match_mask,
            conf)  # the main path's result, in stream order
    mask_k = k_out[1].T.reshape(-1)[:m]
    conf_k = k_out[2].T.reshape(-1)[:m]
    err = max_err((k_out[0], want[0]), (mask_k, want[1]), (conf_k, want[2]))
    require(err == 0, "raw stream: the kernel alone and skipper() differ")
    bound = h100.stream_bytes(num_tiles, RAW_TILE, n, DEFAULT)
    del k_out, mask_k, conf_k, ut, vt

    # the baselines on the same graph
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, r

    baselines = {}
    for name, fn in (
            ("ems_idmm", lambda: ems_idmm(g, device=dev)),
            ("ems_israeli_itai",
             lambda: ems_israeli_itai(g, seed=seed, device=dev)),
            ("sidmm", lambda: sidmm(g, batch_size=SIDMM_BATCH, seed=seed,
                                    device=dev))):
        ms, r = timed(fn)
        c = check_matching(g, r.match_mask)
        rounds = int(r.counters.rounds)
        capped = name != "sidmm" and rounds >= MAX_ROUNDS
        require(bool(c["valid"]), f"{name}: not a valid matching")
        require(bool(c["maximal"]) or capped,
                f"{name}: not maximal below its round cap")
        baselines[name] = {
            "ms": ms, "rounds": rounds, "medges_per_s": m / (ms * 1e-3) / 1e6,
            "matches": int(c["num_matches"]), "maximal": bool(c["maximal"]),
            "stopped_at_round_cap": capped,
            "counters_int32": {f: int(getattr(r.counters, f)) for f in
                               ("edge_reads", "state_loads", "state_stores",
                                "rounds")}}
        log(f"baseline {name}: {ms:.1f} ms, {rounds} rounds, "
            f"{baselines[name]['medges_per_s']:.1f} Medges/s, valid, "
            f"{'maximal' if c['maximal'] else 'NOT maximal: round cap'}")
        del r

    # the baselines on the card against their CPU plain runs, given the
    # same permutations
    small = rmat_graph(10, 8, seed=2)
    gen = torch.Generator().manual_seed(seed)
    pris = [torch.randperm(small.num_edges, generator=gen).to(torch.int32)
            for _ in range(MAX_ROUNDS)]
    perm = torch.randperm(-(-small.num_edges // 512) * 512, generator=gen)
    base_err = 0
    for run in (lambda d: ems_idmm(small, device=d),
                lambda d: ems_israeli_itai(small, priorities=pris.__getitem__,
                                           device=d),
                lambda d: sidmm(small, batch_size=512, perm=perm, device=d)):
        a, b = run(dev), run("cpu")
        base_err = max(base_err, match_err((a, None), (b, None)))
    require(base_err == 0, "a baseline on the card differs from its plain "
            "CPU run given the same permutations")
    log("baselines on the card equal their CPU runs (RMAT 10; IDMM, and "
        "Israeli-Itai and SIDMM given the same permutations)")

    plain_ms, small_k_ms, err16, plain_case = accesses_line(
        dev, seed, RAW_TILE, instance)
    worst = max(worst, err, err16)

    # the APRAM oracle on masks from the card
    t0 = time.perf_counter()
    pins = pin_entry_points(rmat_graph(7, 2, seed=3), window=64,
                            tile_size=32, device=dev,
                            include_distributed=True, include_chaos=True)
    require(len(pins) == 13 and "skipper_match_cuda@u8" in pins
            and "distributed@legacy_i32" in pins
            and "chaos_recover@u8" in pins,
            f"pin_entry_points pinned {sorted(pins)}")
    log(f"APRAM oracle on the card: {len(pins)} entry points pinned as "
        f"reachable traces ({sorted(pins)}) in "
        f"{time.perf_counter() - t0:.1f} s")

    metrics = {
        "graph": f"RMAT scale {edges.num_vertices.bit_length() - 1}, "
                 "reorder none, raw stream",
        "vertices": n, "edges": m, "tile": RAW_TILE, "tiles": num_tiles,
        "instance": instance, "edges_to_card_ms": copy_ms,
        "skipper_ms": sk_ms, "medges_per_s": m / (sk_ms * 1e-3) / 1e6,
        "kernel_ms": k_ms, "kernel_us_per_tile": 1e3 * k_ms / num_tiles,
        "bound_ms": h100.bytes_ms(bound), "peak_device_bytes": peak,
        "skipper_match_ms_same_graph": match_ms,
        "matches": int(chk["num_matches"]), "conflict_table": table,
        "baselines": baselines,
        "plain_case": plain_case, "plain_ms": plain_ms,
        "kernel_ms_plain_case": small_k_ms,
        "phase_s": time.perf_counter() - t_phase}
    log("raw-stream metrics: " + json.dumps(metrics))
    return {"name": ASYNC, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[ASYNC], "path": "skipper (raw stream)",
            "launches": launches[ASYNC], "max_abs_err": worst, "ms": k_ms,
            "plain_ms": plain_ms, "plain_case": plain_case,
            "bound_ms": h100.bytes_ms(bound), "bound_by": "bytes",
            "library_ms": None}


# --------------------------------------------------------------- phase 4c --
#: the global-tier block of phase 4c's full-scale distributed runs: the
#: smallest power of two whose runs keep the phase near 180 s (the
#: reference's default, 512, would take 79,202 and 131,076 host-bound
#: rounds of about 1.2 ms; PERF.md section 4)
DIST_BLOCK = 4096
#: phase 3's small schedules that phase 4c runs on the card
DIST_SMALL = ("all_boundary", "dups_loops")
#: the fault sites, as tests/test_faults.py plans them
DIST_PLANS = {
    "drop": dict(seed=7, drop_proposals=0.3),
    "truncate": dict(seed=7, truncate_retry=0),
    "corrupt": dict(seed=7, corrupt_state=0.05),
    "lose_shard": dict(seed=7, lose_shard=0),
    "skip_drain": dict(seed=7, skip_drain=True),
}
#: the chaos plan of the full-scale skipper_match runs (the APRAM
#: oracle's chaos row)
CHAOS = dict(seed=7, drop_proposals=0.25, corrupt_state=0.05)
DIST_STATS = ("proposals", "lost_proposals", "requeued", "retry_overflow",
              "undrained", "gathered_bytes", "recovery_attempts",
              "residual_edges", "recovered_matches", "corrupted_cells")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def stats_dict(stats) -> dict:
    return {f: int(torch.as_tensor(getattr(stats, f))) for f in DIST_STATS}


def run_err(a, b) -> int:
    """max_abs_err of two matcher results (``(result, stats_or_report)``
    or ``(result, conflicts, report)``): mask, state, counters, and every
    stats or report field."""
    from repro_torch.core.faults import RecoveryReport

    pairs = [(a[0].match_mask, b[0].match_mask), (a[0].state, b[0].state)]
    for f in ("edge_reads", "state_loads", "state_stores", "rounds"):
        pairs.append((getattr(a[0].counters, f), getattr(b[0].counters, f)))
    err = max_err(*((x.cpu(), y.cpu()) for x, y in pairs))
    for x, y in zip(a[1:], b[1:]):
        if isinstance(x, torch.Tensor):
            err = max(err, max_err((x.cpu(), y.cpu())))
        elif isinstance(x, RecoveryReport):
            err = max(err, *(abs(u - w) for u, w in zip(
                dataclasses.astuple(x), dataclasses.astuple(y))))
        else:
            sx, sy = stats_dict(x), stats_dict(y)
            err = max(err, *(abs(sx[f] - sy[f]) for f in DIST_STATS))
    return err


def dist_small(dev):
    """Phase 4c's small cases: ``distributed_skipper`` (one rank, no
    process group) on both schedules, clean and under each fault site
    with ``on_fault="recover"``, and ``skipper_match`` under each site
    live at D = 1, the kernels (``backend="cuda"``) against the plain
    path (``"torch"``) on the same CUDA tensors, bit for bit, at both
    widths. Returns the worst max_abs_err."""
    from repro_torch.core.distributed import distributed_skipper
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.statespec import StateSpec
    from repro_torch.graphs import build_window_schedule
    from repro_torch.kernels.skipper_match import skipper_match

    worst, count, t0 = 0, 0, time.perf_counter()
    for label, edges, window, tile, reorder in small_cases():
        if label not in DIST_SMALL:
            continue
        s = build_window_schedule(edges, window, tile, reorder=reorder)
        g = edges.to(dev)
        kinds = {"dispersed": dict(block_size=2 * tile, tile_size=tile),
                 "sharded": dict(schedule=s, block_size=2 * tile,
                                 tile_size=tile)}
        for spec_name, vr in (("u8", 1), ("legacy_i32", 2)):
            spec = getattr(StateSpec, spec_name)()
            runs = []
            for kind, kw in kinds.items():
                runs.append((f"distributed {kind}", distributed_skipper,
                             dict(kw)))
                for site, plan in DIST_PLANS.items():
                    runs.append((f"distributed {kind} {site}",
                                 distributed_skipper,
                                 dict(kw, faults=FaultPlan(**plan),
                                      on_fault="recover", verify=True)))
            for site in ("drop", "corrupt", "lose_shard"):
                runs.append((f"skipper_match {site}", skipper_match,
                             dict(schedule=s, with_conflicts=True,
                                  faults=FaultPlan(**DIST_PLANS[site]),
                                  on_fault="recover", verify=True)))
            for name, fn, kw in runs:
                got = fn(g, backend="cuda", device=dev, spec=spec,
                         vector_rounds=vr, **kw)
                want = fn(g, backend="torch", device=dev, spec=spec,
                          vector_rounds=vr, **kw)
                err = run_err(got, want)
                count += 1
                require(err == 0, f"{label} {spec_name} rounds={vr} {name}: "
                        f"the kernels and the plain path disagree ({err})")
                worst = max(worst, err)
        log(f"  dist {label:>18}: {len(runs)} runs x 2 widths bit-equal "
            "(kernels against plain)")
    log(f"phase 4c small cases: {count} comparisons in "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


#: launches timed back to back in a slab entry, and the GPU spin (cycles)
#: queued before them so the host enqueues them all ahead of the card
SLAB_REPS = 20
SPIN_CYCLES = 200_000_000


def slab_entry(dev, path, state, u, v, n, tile, launches, worst):
    """A kernels-line entry for the global-tier kernel on a distributed
    path: one slab pass (``engine.stream_pass``'s card route, the kernel
    over one state row of ``n`` cells) on the path's first slab and
    committed state, against the plain version. Timing one call would
    time the host, which enqueues a round's launches one by one; the
    kernel's own time is taken over ``SLAB_REPS`` launches queued behind a
    GPU spin, which the card then runs back to back."""
    from repro_torch.core import engine
    from repro_torch.core.statespec import StateSpec
    from repro_torch.kernels.skipper_match import kernel
    from repro_torch.roofline import h100

    spec = StateSpec(counter="int32")  # the slab pass's widths (u8 state)
    ut, vt = u.reshape(-1, tile), v.reshape(-1, tile)
    pairs = torch.zeros(ut.shape[0], dtype=torch.int32, device=dev)
    rows = [state.reshape(1, n).clone() for _ in range(SLAB_REPS + 1)]

    def launch(row):
        return kernel.boundary_tier(row, pairs, pairs, ut, vt, spec=spec,
                                    check_ids=False)

    launch(rows[-1])  # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for row in rows[:SLAB_REPS]:
        out = launch(row)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / SLAB_REPS
    got = (rows[SLAB_REPS - 1][0], out[0].reshape(-1) > 0,
           out[1].reshape(-1))
    plain_ms, want = cuda_time(lambda: engine.stream_pass(
        state.clone(), u, v, n=n, vector_rounds=1, tile_size=tile,
        backend="torch", checked=True))
    err = max_err(*zip(got, want))
    require(err == 0, f"{path}: the slab kernel and its plain version "
            f"disagree ({err})")
    # the bound counts the state sectors this slab's endpoints touch
    ids = torch.cat([u, v])
    sectors = torch.unique(ids[ids >= 0].long() * spec.vmem_bytes
                           // h100.SECTOR_BYTES).numel()
    bound = h100.slab_bytes(u.numel(), sectors, n, spec)
    return {"name": ASYNC, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[ASYNC], "path": path,
            "launches": launches, "max_abs_err": max(worst, err), "ms": ms,
            "plain_ms": plain_ms,
            "plain_case": f"one slab pass of {ut.shape[0]} tiles of {tile} "
                          f"over {n} cells, the path's first",
            "state_sectors": sectors,
            "bound_ms": h100.bytes_ms(bound), "bound_by": "bytes",
            "library_ms": None}


def timed_run(fn):
    """``(CUDA-event ms, host s, launches, result)`` of one run, with the
    launch counts reset just before it."""
    from repro_torch.kernels.skipper_match import kernel

    kernel.reset_launch_counts()
    t0 = time.perf_counter()
    ms, out = cuda_time(fn)
    return ms, time.perf_counter() - t0, kernel.launch_counts(), out


def phase_dist(dev, edges, phase4, block: int):
    """Phase 4c: the distributed matcher and the fault harness on the card.
    Small cases, kernels against plain; then, in a one-rank NCCL group,
    ``distributed_skipper`` on phase 4's schedule (equal to phase 4's
    ``skipper_match`` bit for bit) and on the raw stream (checked), the
    chaos ``skipper_match`` under ``"report"`` and ``"recover"``, and
    ``distributed_skipper(on_fault="recover")`` with a lost shard and with
    a truncated retry buffer. Returns the kernels line's entries."""
    import torch.distributed as dist

    from repro_torch.core import check_matching, check_state_domain
    from repro_torch.core.distributed import distributed_skipper
    from repro_torch.core.faults import FaultPlan
    from repro_torch.graphs import partition_schedule
    from repro_torch.kernels.skipper_match import skipper_match

    t_phase = time.perf_counter()
    worst = dist_small(dev)
    s, res = phase4["schedule"], phase4["result"]
    tile = s.tile_size
    metrics = {"block_size": block, "tile": tile}

    torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    require(dist.get_backend() == "nccl", "the process group is not NCCL")
    log(f"process group: backend {dist.get_backend()}, world size "
        f"{dist.get_world_size()}")

    def check(label, g, mask, state):
        chk = check_matching(g, mask)
        dom = check_state_domain(state)
        require(bool(chk["valid"]) and bool(chk["maximal"]),
                f"{label}: check_matching failed {chk}")
        require(bool(dom["clean"]), f"{label}: state domain {dom}")
        return int(chk["num_matches"])

    def report_run(label, ms, host_s, launches, rounds, stats=None):
        rec = {"ms": ms, "host_s": host_s, "launches": launches}
        if rounds:
            rec.update(rounds=rounds, ms_per_round=ms / rounds)
        if stats is not None:
            rec["stats"] = stats_dict(stats)
        metrics[label] = rec
        log(f"{label}: " + json.dumps(rec))

    edges_dev = edges.to(dev)
    # the locality-sharded schedule, D = 1: phase 4's schedule and result
    ds = partition_schedule(s, 1, block)
    rounds_sh = ds.num_rounds + 4
    ms, host_s, launches_sh, (rd, st) = timed_run(
        lambda: distributed_skipper(edges, schedule=s, block_size=block,
                                    device=dev))
    report_run("sharded", ms, host_s, launches_sh, rounds_sh, st)
    require(torch.equal(rd.match_mask, res.match_mask)
            and torch.equal(rd.state, res.state),
            "the sharded run differs from phase 4's skipper_match")
    require(st.ok, "the sharded run tripped a must-be-zero invariant")
    require(launches_sh[WINDOW_ASYNC] == 1
            and launches_sh[ASYNC] == 2 * rounds_sh
            and launches_sh[WINDOW] == 0 and launches_sh[BOUNDARY] == 0,
            f"the sharded run's launches: {launches_sh}")
    log(f"sharded D=1: bit-equal to phase 4's skipper_match (mask and "
        f"state), {int(res.match_mask.sum())} matches, "
        f"{ds.num_rounds} rounds + 4 drains of block {block}")
    del rd, st

    # the dispersed schedule on the raw stream, D = 1
    rounds_dp = -(-edges.num_edges // block) + 4
    ms, host_s, launches_dp, (rp, st) = timed_run(
        lambda: distributed_skipper(edges_dev, block_size=block,
                                    tile_size=tile, device=dev))
    report_run("dispersed", ms, host_s, launches_dp, rounds_dp, st)
    require(st.ok, "the dispersed run tripped a must-be-zero invariant")
    require(launches_dp[ASYNC] == 2 * rounds_dp
            and sum(launches_dp.values()) == launches_dp[ASYNC],
            f"the dispersed run's launches: {launches_dp}")
    matches = check("dispersed", edges_dev, rp.match_mask, rp.state)
    ec = edges_dev.canonical()
    slot_certificate(ec.u.long(), ec.v.long(),
                     torch.arange(ec.num_edges, device=dev), rp.match_mask,
                     edges.num_vertices, "dispersed certificate")
    log(f"dispersed D=1: valid maximal matching of {matches} edges, state "
        "clean, greedy certificate in stream order holds")
    del rp, st

    # chaos: skipper_match under the oracle's chaos plan
    plan = FaultPlan(**CHAOS)
    ms, host_s, launches, (r, rep) = timed_run(
        lambda: skipper_match(edges, schedule=s, faults=plan,
                              on_fault="report", device=dev))
    report_run("chaos_report", ms, host_s, launches, 0)
    metrics["chaos_report"]["report"] = dataclasses.astuple(rep)
    require(rep.residual_edges > 0 and rep.corrupted_cells > 0,
            f"the chaos plan did not bite: {rep}")
    ms, host_s, launches, (r, rep) = timed_run(
        lambda: skipper_match(edges, schedule=s, faults=plan,
                              on_fault="recover", verify=True, device=dev))
    report_run("chaos_recover", ms, host_s, launches, 0)
    metrics["chaos_recover"]["report"] = dataclasses.astuple(rep)
    require(launches[ASYNC] == 2, f"chaos recover launches: {launches}")
    matches = check("chaos recover", edges_dev, r.match_mask, r.state)
    log(f"chaos skipper_match: report {dataclasses.astuple(rep)}; recovered "
        f"to a valid maximal matching of {matches} edges, state clean")
    del r

    # the ladder across the protocol: a lost shard, a truncated buffer
    for label, kw in (("lose_shard", dict(lose_shard=0)),
                      ("truncate_retry", dict(truncate_retry=0))):
        plan = FaultPlan(seed=7, **kw)
        ms, host_s, launches, (r, st) = timed_run(
            lambda: distributed_skipper(edges, schedule=s, block_size=block,
                                        faults=plan, on_fault="recover",
                                        verify=True, device=dev))
        report_run(f"recover_{label}", ms, host_s, launches, 0, st)
        matches = check(f"recover {label}", edges_dev, r.match_mask, r.state)
        log(f"distributed recover {label}: valid maximal matching of "
            f"{matches} edges, state clean")
        del r, st
    dist.destroy_process_group()

    # the kernels line: the two matcher kernels on their new paths, each
    # slab kernel timed on its path's first slab against the plain pass
    # the first round's slab (an empty retry buffer, then block 0) against
    # the committed state after phase A
    n_flat = s.num_windows * s.window
    pad = torch.full((block,), -1, dtype=torch.int32, device=dev)
    committed = torch.zeros((s.num_windows, s.window), dtype=torch.uint8,
                            device=dev)
    committed[put(s.window_ids, dev).long()] = _window_states(s, dev)
    committed = committed.reshape(-1)
    u = torch.cat([pad, put(ds.boundary_ub[0, 0], dev)])
    v = torch.cat([pad, put(ds.boundary_vb[0, 0], dev)])
    valid = (u >= 0) & (u != v)
    u, v = torch.where(valid, u, -1), torch.where(valid, v, -1)
    entries = [dict(phase4["window_entry"],
                    path="distributed_skipper (locality-sharded, D = 1, "
                         "NCCL): phase A", launches=launches_sh[WINDOW_ASYNC],
                    max_abs_err=max(phase4["window_entry"]["max_abs_err"],
                                    worst))]
    entries.append(slab_entry(
        dev, "distributed_skipper (locality-sharded, D = 1, NCCL): "
             f"{rounds_sh} rounds x 2 slab passes", committed, u, v, n_flat,
        tile, launches_sh[ASYNC], worst))
    ec = edges_dev.canonical()
    u = torch.cat([pad, ec.u[:block]])
    v = torch.cat([pad, ec.v[:block]])
    valid = (u >= 0) & (u != v)
    u, v = torch.where(valid, u, -1), torch.where(valid, v, -1)
    entries.append(slab_entry(
        dev, "distributed_skipper (dispersed raw stream, D = 1, NCCL): "
             f"{rounds_dp} rounds x 2 slab passes",
        torch.zeros(edges.num_vertices, dtype=torch.uint8, device=dev), u,
        v, edges.num_vertices, tile, launches_dp[ASYNC], worst))
    metrics["phase_s"] = time.perf_counter() - t_phase
    log("distributed metrics: " + json.dumps(metrics))
    return entries


def _window_states(s, dev):
    """Phase A's committed rows of schedule ``s`` (u8), through the window
    tier kernel."""
    from repro_torch.core import engine

    states, _, _ = engine.window_tier_pass(
        put(s.u_tiles, dev), put(s.v_tiles, dev), window=s.window,
        tiles_per_window=s.tiles_per_window, tile_size=s.tile_size,
        vector_rounds=1, backend="cuda")
    return states


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
    require(len(report.targets_analyzed) == ANALYSIS_TARGETS
            == len(atargets.target_names()),
            f"analysis: {len(report.targets_analyzed)} targets analyzed, "
            f"not {ANALYSIS_TARGETS}")

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
#: zamba2-2.7b's attention widths (src/repro/configs/zamba2_2_7b.py: d_model
#: 2560, 32 heads, no grouping): head dim 80
ZAMBA2_ATTN = dict(b=1, hq=32, hkv=32, d=80)


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
    cases.append(("zamba2 S=4096", ZAMBA2_ATTN, 4096, True, 0))
    return cases


def step_misses(got: torch.Tensor, plain: torch.Tensor) -> int:
    """Elements of a bf16 result more than one bf16 step (+ the floor) from
    the plain value."""
    diff = (got.float() - plain.float()).abs()
    return int((diff > bf16_step(plain) + BF16_STEP_FLOOR).sum())


def phase_flash(dev, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, kernel
    from repro_torch.kernels.flash_attention.ref import (
        online_softmax_attention, tf32_planes)
    from repro_torch.models.layers import gqa_attention_chunked
    from repro_torch.roofline import h100

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {kernel.FLASH: 0.0, kernel.FLASH_WGMMA: 0.0,
             kernel.FLASH_TF32: 0.0, kernel.FLASH_SPLIT: 0}
    worst_f32 = 0.0     # the three-term kernel's, on f32 inputs only
    # why P is split in three: the outputs one and two bf16 terms leave
    # more than one step from the plain version (reported, not held)
    p_term_misses = {}
    zamba2 = {}
    t0 = time.perf_counter()
    for label, w, s, causal, window in flash_cases():
        for dtype in (torch.float32, torch.bfloat16):
            tol_plain, tol_model = FLASH_TOL[dtype]
            q, k, v = flash_inputs(gen, w["b"], w["hq"], w["hkv"], s, w["d"],
                                   dtype, dev)
            blk = min(128, s)
            name = kernel.kernel_for(dtype, w["d"])
            kw = dict(causal=causal, window=window, sm_scale=w["d"] ** -0.5)
            got = kernel.flash_attention_cuda(q, k, v, **kw, block_q=blk,
                                              block_k=blk)
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
            log(f"  flash {label:>28} {str(dtype)[6:]:>8} {name}: "
                f"kernel-plain {err:.3e} (tol {tol_plain}"
                f"{', one bf16 step' if dtype == torch.bfloat16 else ''}), "
                f"kernel-model {err_model:.3e} (tol {tol_model})")
            require(ok and err_model <= tol_model,
                    f"flash {label} {dtype}: kernel and plain version or "
                    "model attention disagree")
            worst[name] = max(worst[name], err)
            if name == kernel.FLASH_TF32 and dtype == torch.float32:
                worst_f32 = max(worst_f32, err)
            if name == kernel.FLASH_TF32:
                # the pre-pass, bit for bit against the plain split
                planes = kernel.split_tf32_cuda(q, k, v, w["d"] ** -0.5)
                want = tf32_planes(q, k, v, w["d"] ** -0.5)
                for plane, x in planes.items():
                    require((x is None) == (want[plane] is None),
                            f"flash {label}: pre-pass plane {plane}")
                    if x is not None:
                        worst[kernel.FLASH_SPLIT] = max(
                            worst[kernel.FLASH_SPLIT],
                            int((x != want[plane]).sum()))
                require(worst[kernel.FLASH_SPLIT] == 0,
                        f"flash {label} {dtype}: the pre-pass differs from "
                        "ref.tf32_planes")
                del planes, want
            if dtype == torch.bfloat16:
                # the CUDA-core kernel on the same bf16 inputs
                old = kernel.flash_attention_cuda_cores(
                    q, k, v, **kw, block_q=blk, block_k=blk)
                err_old, ok = compare_flash(old, plain)
                require(ok, f"flash {label}: the CUDA-core kernel and the "
                        f"plain version disagree ({err_old})")
                worst[kernel.FLASH] = max(worst[kernel.FLASH], err_old)
                if name == kernel.FLASH_WGMMA:
                    p_term_misses[label] = [step_misses(
                        kernel.flash_attention_wgmma_p_terms(
                            q, k, v, **kw, p_terms=n), plain)
                        for n in (1, 2)]
                del old
            if w is ZAMBA2_ATTN:
                # head dim 80 on the tensor cores beside the CUDA-core kernel
                blocks = dict(block_q=blk, block_k=blk)
                new_ms, _ = cuda_time(lambda: kernel.flash_attention_cuda(
                    q, k, v, **kw, **blocks), reps=3)
                old_ms, _ = cuda_time(
                    lambda: kernel.flash_attention_cuda_cores(
                        q, k, v, **kw, **blocks), reps=2)
                bound, bound_by = h100.flash_bound_ms(
                    w["b"], w["hq"], w["hkv"], s, w["d"], str(dtype)[6:])
                zamba2[str(dtype)[6:]] = {
                    "kernel": name, "kernel_ms": new_ms,
                    "cuda_core_kernel_ms": old_ms, "bound_ms": bound,
                    "bound_by": bound_by, "kernel_vs_plain_err": err,
                    "kernel_vs_model_err": err_model}
            del q, k, v, got, plain, model

    # the path: the entry point at granite's prefill_32k attention shape,
    # in bf16 (the bf16 tensor-core kernel) and in f32 (the three-term
    # kernel after its pre-pass), the f32 inputs drawn in f32
    w, s = GRANITE_ATTN, 32768
    q, k, v = flash_inputs(gen, w["b"], w["hq"], w["hkv"], s, w["d"],
                           torch.bfloat16, dev)
    q32, k32, v32 = flash_inputs(gen, w["b"], w["hq"], w["hkv"], s, w["d"],
                                 torch.float32, dev)
    kernel.reset_launch_counts()
    out = flash_attention(q, k, v, causal=True)
    out32 = flash_attention(q32, k32, v32, causal=True)
    torch.cuda.synchronize()
    launches = kernel.launch_counts()
    require(launches[kernel.FLASH_WGMMA] > 0
            and launches[kernel.FLASH_TF32] > 0
            and launches[kernel.FLASH_SPLIT] > 0,
            f"flash_attention did not launch its kernels: {launches}")
    require(launches[kernel.FLASH] == 0,
            f"flash_attention launched the CUDA-core kernel: {launches}")
    require(bool(torch.isfinite(out).all())
            and bool(torch.isfinite(out32).all()), "prefill_32k: non-finite")
    del out, out32
    kw = dict(causal=True, window=0, sm_scale=w["d"] ** -0.5)
    blocks = dict(block_q=128, block_k=128)
    ms, got = cuda_time(lambda: kernel.flash_attention_cuda(
        q, k, v, **kw, **blocks), reps=3)
    old_ms, old = cuda_time(lambda: kernel.flash_attention_cuda_cores(
        q, k, v, **kw, **blocks))
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
    err_old, ok = compare_flash(old, plain)
    require(ok, f"prefill_32k bf16: the CUDA-core kernel and the plain "
            f"version disagree ({err_old})")
    worst[kernel.FLASH_WGMMA] = max(worst[kernel.FLASH_WGMMA], err)
    worst[kernel.FLASH] = max(worst[kernel.FLASH], err_old)
    terms_ms = {}
    for n in (1, 2):
        terms_ms[n], one = cuda_time(
            lambda: kernel.flash_attention_wgmma_p_terms(q, k, v, **kw,
                                                         p_terms=n))
        p_term_misses.setdefault("prefill_32k", []).append(
            step_misses(one, plain))
        del one
    bound, bound_by = h100.flash_bound_ms(w["b"], w["hq"], w["hkv"], s,
                                          w["d"], "bfloat16")
    del q, k, v, got, old, lib, plain
    # the same shape in f32, held at 2e-5: the three-term kernel (whole,
    # its pre-pass alone, and the main kernel alone on the pre-pass's
    # planes), the CUDA-core kernel, the plain version and SDPA
    # (memory-efficient backend, K and V repeated to the query heads; see
    # the module docstring), all on the same f32-drawn inputs
    f32_ms, got = cuda_time(lambda: kernel.flash_attention_cuda(
        q32, k32, v32, **kw, **blocks), reps=3)
    split_ms, planes = cuda_time(lambda: kernel.split_tf32_cuda(
        q32, k32, v32, kw["sm_scale"]), reps=3)
    main_out = torch.empty_like(q32)
    main_ms, main = cuda_time(lambda: kernel.tf32x3_on_planes(
        planes, main_out, w["hkv"], causal=True, window=0), reps=3)
    require(torch.equal(main, got), "prefill_32k f32: the main kernel on "
            "the pre-pass's planes differs from the entry point")
    split_plain_ms, want = cuda_time(lambda: tf32_planes(
        q32, k32, v32, kw["sm_scale"]))
    split_diff = sum(int((x != want[n]).sum()) for n, x in planes.items())
    require(split_diff == 0, f"prefill_32k f32: the pre-pass differs from "
            f"ref.tf32_planes in {split_diff} elements")
    del planes, want, main, main_out
    old32_ms, old32 = cuda_time(lambda: kernel.flash_attention_cuda_cores(
        q32, k32, v32, **kw, **blocks))
    plain32_ms, plain = cuda_time(lambda: online_softmax_attention(
        q32, k32, v32, block_q=128, block_k=128, causal=True))
    err_f32, ok = compare_flash(got, plain)
    require(ok, f"prefill_32k f32: kernel and plain version disagree "
            f"({err_f32}, tolerance 2e-5)")
    err_old32, ok = compare_flash(old32, plain)
    require(ok, f"prefill_32k f32: the CUDA-core kernel and the plain "
            f"version disagree ({err_old32}, tolerance 2e-5)")
    worst[kernel.FLASH_TF32] = max(worst[kernel.FLASH_TF32], err_f32)
    worst_f32 = max(worst_f32, err_f32)
    worst[kernel.FLASH] = max(worst[kernel.FLASH], err_old32)
    del got, old32
    from torch.nn.attention import SDPBackend, sdpa_kernel

    k32r, v32r = (t.repeat_interleave(w["hq"] // w["hkv"], 1)
                  for t in (k32, v32))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        cuda_time(lambda: F.scaled_dot_product_attention(
            q32, k32r, v32r, is_causal=True))                 # warm-up
        lib32_ms, lib32 = cuda_time(lambda: F.scaled_dot_product_attention(
            q32, k32r, v32r, is_causal=True), reps=3)
    err_lib32, ok = compare_flash(lib32, plain)
    require(ok, f"prefill_32k f32: SDPA and the plain version disagree "
            f"({err_lib32}, tolerance 2e-5)")
    bound32, bound32_by = h100.flash_bound_ms(w["b"], w["hq"], w["hkv"], s,
                                              w["d"], "float32")
    cuda_core_bound32 = h100.flash_cuda_core_bound_ms(w["b"], w["hq"], s,
                                                      w["d"])
    # the pre-pass reads q, k and v once and writes each as a hi and a lo
    # plane, all f32 (no padding at D = 64)
    split_bound = h100.bytes_ms(3 * 4 * (q32.numel() + 2 * k32.numel()))
    del q32, k32, v32, k32r, v32r, lib32, plain
    # kernels and plain version beside each other at S = 4096
    q, k, v = flash_inputs(gen, w["b"], w["hq"], w["hkv"], 4096, w["d"],
                           torch.bfloat16, dev)
    ms_4k, _ = cuda_time(lambda: kernel.flash_attention_cuda(
        q, k, v, **kw, **blocks), reps=3)
    old_4k, _ = cuda_time(lambda: kernel.flash_attention_cuda_cores(
        q, k, v, **kw, **blocks), reps=3)
    plain_4k, _ = cuda_time(lambda: online_softmax_attention(
        q, k, v, block_q=128, block_k=128, causal=True), reps=2)
    del q, k, v
    metrics = {
        "shape": "B=1 S=32768 Hq=24 Hkv=8 D=64 causal bf16",
        "kernel_ms": ms, "cuda_core_kernel_ms": old_ms,
        "cuda_core_kernel_f32_ms": old32_ms, "plain_ms": plain_ms,
        "sdpa_ms": lib_ms, "bound_ms": bound, "bound_by": bound_by,
        "f32": {"inputs": "drawn in f32",
                "kernel": kernel.FLASH_TF32, "kernel_ms": f32_ms,
                "main_kernel_ms": main_ms, "pre_pass_ms": split_ms,
                "pre_pass_plain_ms": split_plain_ms,
                "pre_pass_bound_ms": split_bound,
                "cuda_core_kernel_ms": old32_ms, "plain_ms": plain32_ms,
                "sdpa_ms": lib32_ms, "bound_ms": bound32,
                "bound_by": bound32_by,
                "cuda_core_bound_ms": cuda_core_bound32,
                "kernel_over_bound": f32_ms / bound32,
                "kernel_over_sdpa": f32_ms / lib32_ms,
                "cuda_core_over_kernel": old32_ms / f32_ms,
                "kernel_vs_plain_err": err_f32,
                "cuda_core_vs_plain_err": err_old32,
                "sdpa_vs_plain_err": err_lib32},
        "zamba2_s4096": zamba2,
        "kernel_over_bound": ms / bound, "kernel_over_sdpa": ms / lib_ms,
        "p_terms": kernel.P_TERMS,
        "kernel_ms_by_p_terms": {1: terms_ms[1], 2: terms_ms[2],
                                 kernel.P_TERMS: ms},
        "step_misses_by_p_terms_1_2": p_term_misses,
        "kernel_vs_plain_err": err, "cuda_core_vs_plain_err": err_old,
        "kernel_vs_plain_err_f32": err_f32, "kernel_vs_sdpa_err": err_lib,
        "kernel_ms_s4096": ms_4k, "cuda_core_kernel_ms_s4096": old_4k,
        "plain_ms_s4096": plain_4k, "launches_on_path": launches,
        "worst_err": worst, "worst_err_tf32x3_f32": worst_f32,
        "seconds": time.perf_counter() - t0,
    }
    log("flash metrics: " + json.dumps(metrics))
    return [
        {"name": kernel.FLASH_WGMMA, "route": "cuda",
         "source": FLASH_WGMMA_SOURCE,
         "replaces": REPLACES[kernel.FLASH_WGMMA],
         "launches": launches[kernel.FLASH_WGMMA],
         "max_abs_err": worst[kernel.FLASH_WGMMA], "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
         "library_ms": lib_ms},
        # f32 and D = 80: the main kernel alone on the pre-pass's planes
        # at the path's f32 call (the whole call is f32.kernel_ms in the
        # metrics line)
        {"name": kernel.FLASH_TF32, "route": "cuda",
         "source": FLASH_TF32_SOURCE,
         "replaces": REPLACES[kernel.FLASH_TF32],
         "launches": launches[kernel.FLASH_TF32],
         "max_abs_err": worst[kernel.FLASH_TF32], "ms": main_ms,
         "plain_ms": plain32_ms, "bound_ms": bound32,
         "bound_by": bound32_by, "library_ms": lib32_ms},
        # its pre-pass: no single PyTorch call splits to TF32 planes
        {"name": kernel.FLASH_SPLIT, "route": "cuda",
         "source": FLASH_TF32_SOURCE,
         "replaces": REPLACES[kernel.FLASH_SPLIT],
         "launches": launches[kernel.FLASH_SPLIT],
         "max_abs_err": worst[kernel.FLASH_SPLIT], "ms": split_ms,
         "plain_ms": split_plain_ms, "bound_ms": split_bound,
         "bound_by": "bytes", "library_ms": None},
        # the first kernel, now on no path: the yardstick, on the path's
        # f32 inputs (its bf16 time is cuda_core_kernel_ms in the metrics
        # line; its CUDA-core bound f32.cuda_core_bound_ms)
        {"name": kernel.FLASH, "route": "cuda", "source": FLASH_SOURCE,
         "replaces": REPLACES[kernel.FLASH], "status": "superseded",
         "launches": launches[kernel.FLASH],
         "max_abs_err": worst[kernel.FLASH], "ms": old32_ms,
         "plain_ms": plain32_ms, "bound_ms": bound32,
         "bound_by": bound32_by, "library_ms": lib32_ms},
    ]


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


def decode_call(kw) -> bool:
    """A ``bmatch_assign`` call of a decode step (one token)."""
    return kw["num_tokens"] == 1


class BmatchTimer:
    """Test hook for a timed run: swaps ``moe.bmatch_assign`` for a wrapper
    that records a CUDA event before and after each call that ``select``
    picks from its keywords (by default the decode steps' calls, one
    token), with no sync and no copy (two event records a call are its
    whole cost), and puts the original back on exit. ``seconds`` sums the
    device-timeline spans of the calls once the run has ended."""

    def __init__(self, select=decode_call):
        from repro_torch.models import moe

        self.moe = moe
        self.select = select
        self.events = []

    def __enter__(self):
        self.saved = self.moe.bmatch_assign

        def wrapped(token_ids, expert_ids, **kw):
            if not self.select(kw):
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


def trace_decode(step_fn, steps: int = 1, top: int = 8) -> dict:
    """``steps`` calls of ``step_fn`` traced with ``torch.profiler``: the
    device's busy share of the traced wall time (the sum of kernel times
    over it; the profiler's own host cost makes the idle share an upper
    bound) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step_fn()
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
    if not rows:
        log("profiler: no device time recorded; busy share not measured")
        return {"profiled_decode_steps": steps, "device_busy_share": None}
    return {
        "profiled_decode_steps": steps,
        "profiled_ms_per_step": wall_us / steps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "device_ms_per_step": busy_us / steps / 1e3,
        "device_launches_per_step": sum(r[2] for r in rows) / steps,
        "top_device_kernels": [
            {"name": k[:80], "ms_per_step": us / steps / 1e3,
             "launches_per_step": n / steps} for us, k, n in rows[:top]],
    }


def profile_decode(arch: str, dev, seed: int, prompt_len: int,
                   steps: int = 8) -> dict:
    """Trace ``steps`` decode steps of one request with ``torch.profiler``
    (the serve path's own steps on a model drawn as ``serve`` draws it;
    ``trace_decode``)."""
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
    state = {"tok": torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None],
             "cache": cache}
    step = make_serve_step(cfg)

    def one():
        state["tok"], state["cache"] = step(model, state["cache"],
                                            state["tok"])

    one()                                     # warm
    out = trace_decode(one, steps)
    del model, cache, state
    return out


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
    flash_launches = sum(flash.launch_counts().values())
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
    log("flash attention kernel launches on the serving path: "
        f"{flash_launches} (the model's attention is the plain chunked form, "
        "as in the JAX package)")


# --------------------------------------------------------------- phase 6b --
#: the ssm, hybrid, audio and vlm families: each smoke config on the card
#: against the port's CPU path (f32, relative to each tensor's largest
#: magnitude), the vlm's image prefix (16 patches, 4x4), the decode steps
FAMILY_ARCHS = ("mamba2-130m", "zamba2-2.7b", "whisper-large-v3",
                "qwen2-vl-2b")
FAMILY_TOL = 1e-4
FAMILY_IMG, FAMILY_GRID = 16, (4, 4)
FAMILY_STEPS = 3
#: full width and depth (bf16, seeded weights): mamba2 and zamba2 served
#: (prompts of 512, a multiple of both chunks), qwen2-vl and whisper
#: through the adapters; 16 new tokens each
FAMILY_SERVE = dict(num_requests=4, slots=2, prompt_len=512, max_new=16)
VLM_TEXT = 512
AUDIO_PROMPT = 64
FAMILY_NEW = 16
#: the SSD duality at full width in f32: token-by-token decode from an
#: empty cache against the chunked forward, the reference's bound
#: (tests/test_models.py:101)
DUALITY = {"mamba2-130m": 128, "zamba2-2.7b": 64}
DUALITY_TOL = 2e-2


def family_batch(cfg, seed: int, b: int, s: int, dev, n_img: int = FAMILY_IMG,
                 grid=FAMILY_GRID, mask: bool = False) -> dict:
    """A batch of ``cfg``'s family made with numpy from ``seed``: tokens
    ``[b, s]`` (and a loss mask), the vlm's N(0, 1) image prefix of
    ``n_img`` patches on ``grid`` and its M-RoPE positions, the audio
    family's ``encoder_frames`` N(0, 1) frames; bf16 models get them in
    f32, as the reference's batches come."""
    from repro_torch.models.vlm import make_mrope_positions

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if mask:
        batch["mask"] = rng.random((b, s)) > 0.2
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, n_img, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = make_mrope_positions(
            b, n_img + s, n_img, grid).numpy()
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def families_small(dev, seed: int, archs=FAMILY_ARCHS) -> dict:
    """Phase 6b(a): each smoke config, in f32, with weights drawn on a CPU
    generator and copied to the card: prefill logits and every cache
    tensor, then FAMILY_STEPS decode steps (the CPU's greedy tokens fed to
    both), on the card against the port's CPU path within FAMILY_TOL of
    each tensor's largest magnitude; ``pos`` and ``cur`` equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import adapters

    out = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        require(cfg.dtype == "float32", f"{arch}: smoke config not f32")
        batch = family_batch(cfg, seed, 2, 32, "cpu")
        max_len = 32 + FAMILY_IMG + FAMILY_STEPS + 1
        models = {d: adapters.init_fn(torch.Generator().manual_seed(seed),
                                      cfg).to(d) for d in ("cpu", dev)}
        worst = 0.0

        def compare(runs, what):
            nonlocal worst
            (l0, c0), (l1, c1) = runs["cpu"], runs[dev]
            worst = max(worst, rel_err(l1.cpu(), l0))
            require(set(c0) == set(c1), f"{arch}: cache keys differ")
            for k, v in c0.items():
                if k == "cur" or v.dtype == torch.int32:
                    same = (v == c1[k] if k == "cur"
                            else torch.equal(v, c1[k].cpu()))
                    require(bool(same), f"{arch} {what}: cache {k} differs")
                else:
                    worst = max(worst, rel_err(c1[k].cpu(), v))
            require(worst <= FAMILY_TOL, f"{arch} {what}: the card and the "
                    f"CPU differ by {worst:.2e} (over {FAMILY_TOL})")
            return l0

        with torch.no_grad():
            runs = {d: adapters.prefill_fn(
                m, {k: v.to(d) for k, v in batch.items()}, cfg,
                max_len=max_len) for d, m in models.items()}
            logits = compare(runs, "prefill")
            for step in range(FAMILY_STEPS):
                tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
                runs = {d: adapters.decode_fn(m, runs[d][1], tok.to(d), cfg)
                        for d, m in models.items()}
                logits = compare(runs, f"decode step {step}")
        out[arch] = worst
        log(f"family {arch} (smoke, f32): prefill and {FAMILY_STEPS} decode "
            f"steps on the card equal the CPU within {worst:.2e}")
        del models
    return out


def family_serve(arch: str, dev, seed: int) -> dict:
    """Phase 6b(b), mamba2 and zamba2: ``serve`` at full width and depth,
    twice (the first run's logits all finite, request 0's tokens the same
    in both), the second run timed; then one decode step traced."""
    from repro_torch.configs import get_config
    from repro_torch.launch import adapters
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = get_config(arch)
    kw = dict(FAMILY_SERVE, seed=seed, device=dev)
    with Recorder() as rec:
        out1, _ = serve(arch, False, **kw)
    require(rec.finite and rec.logit_calls > 0,
            f"{arch} serving: non-finite logits")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out2, st = serve(arch, False, **kw)
    peak = torch.cuda.max_memory_allocated()
    require(out1[0] == out2[0], f"{arch} serving: request 0 differs between "
            "runs")
    require(all(len(v) == kw["max_new"] or v[-1] == 2 for v in out2.values()),
            f"{arch} serving: a request stopped early without EOS")
    metrics = {
        "layers": cfg.num_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "requests": kw["num_requests"], "slots": kw["slots"],
        "prompt_len": kw["prompt_len"], "max_new": kw["max_new"],
        "prefill_ms": 1e3 * sum(st["prefill_s"]) / len(st["prefill_s"]),
        "prefill_ms_each": [1e3 * x for x in st["prefill_s"]],
        "decode_tokens_per_s": st["decoded"] / st["decode_s"],
        "decoded": st["decoded"], "peak_device_bytes": peak,
        "logit_calls_finite": rec.logit_calls,
        "request0_tokens": out2[0][:8]}
    # one decode step of one request, traced
    model = adapters.init_fn(torch.Generator(device=dev).manual_seed(seed),
                             cfg)
    prompt = family_batch(cfg, seed, 1, kw["prompt_len"], dev)
    logits, cache = make_prefill_step(cfg)(model, prompt)
    state = {"tok": torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None],
             "cache": cache}
    step = make_serve_step(cfg)

    def one():
        state["tok"], state["cache"] = step(model, state["cache"],
                                            state["tok"])

    one()                                     # warm
    metrics.update(trace_decode(one))
    del model, cache, state
    return metrics


def family_adapters(arch: str, dev, seed: int) -> dict:
    """Phase 6b(b), qwen2-vl and whisper: ``adapters.prefill_fn`` and
    FAMILY_NEW greedy ``decode_fn`` steps at full width and depth, batch 1
    (qwen2-vl: 1,024 image tokens on the 32x32 grid and 512 text tokens;
    whisper: 1,500 frames and a 64-token prompt); every logit finite;
    prefill ms, decode tokens/s and peak bytes (host clock ending in a
    sync), then one decode step traced."""
    from repro_torch.configs import get_config
    from repro_torch.launch import adapters

    cfg = get_config(arch)
    if cfg.family == "vlm":
        s, extra = VLM_TEXT, adapters.VLM_IMAGE_TOKENS
        batch = family_batch(cfg, seed, 1, s, dev, n_img=extra,
                             grid=adapters.VLM_GRID)
    else:
        s, extra = AUDIO_PROMPT, 0
        batch = family_batch(cfg, seed, 1, s, dev)
    max_len = extra + s + FAMILY_NEW + 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = adapters.init_fn(torch.Generator(device=dev).manual_seed(seed),
                             cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = adapters.prefill_fn(model, batch, cfg,
                                            max_len=max_len)
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        # a device flag: no sync inside the timed loop
        finite = torch.isfinite(logits).all()
        tokens = []
        t0 = time.perf_counter()
        for _ in range(FAMILY_NEW):
            logits, cache = adapters.decode_fn(model, cache, tok, cfg)
            finite &= torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            tokens.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        require(bool(finite), f"{arch}: non-finite logits")
        state = {"tok": tok, "cache": cache}

        def one():
            logits, state["cache"] = adapters.decode_fn(
                model, state["cache"], state["tok"], cfg)
            state["tok"] = torch.argmax(logits[:, -1:], -1).to(torch.int32)

        one()                                 # warm
        traced = trace_decode(one)
    tokens = torch.cat(tokens, 1)[0].tolist()
    del model, cache, state
    return dict({"layers": cfg.num_layers, "d_model": cfg.d_model,
                 "dtype": cfg.dtype, "prefix_tokens": extra,
                 "prompt_len": s, "max_new": FAMILY_NEW,
                 "prefill_ms": prefill_ms,
                 "decode_tokens_per_s": FAMILY_NEW / decode_s,
                 "peak_device_bytes": peak, "tokens": tokens[:8]}, **traced)


def ssd_duality(arch: str, dev, seed: int) -> dict:
    """Phase 6b(c): ``arch`` at full width and depth in f32: DUALITY[arch]
    tokens decoded one at a time from an empty cache against the chunked
    ``forward`` on the same tokens, within DUALITY_TOL (absolute, on the
    logits)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import adapters

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    n = DUALITY[arch]
    model = adapters.init_fn(torch.Generator(device=dev).manual_seed(seed),
                             cfg)
    tokens = family_batch(cfg, seed, 1, n, dev)["tokens"]
    t0 = time.perf_counter()
    with torch.no_grad():
        chunked = model(tokens)
        cache = model.init_cache(1, n)
        outs = []
        for i in range(n):
            logits, cache = model.decode_step(cache, tokens[:, i:i + 1])
            outs.append(logits[:, 0])
        err = float((torch.stack(outs, 1) - chunked).abs().max())
        scale = float(chunked.abs().max())
    require(err < DUALITY_TOL, f"{arch}: token-by-token decode differs from "
            f"the chunked forward by {err:.3e} (over {DUALITY_TOL})")
    del model, cache, chunked, outs
    torch.cuda.empty_cache()
    log(f"SSD duality {arch} (f32, full width, {n} tokens, chunk "
        f"{cfg.ssm_chunk}): max |decode - forward| {err:.3e} of logits up "
        f"to {scale:.3f}")
    return {"tokens": n, "chunk": cfg.ssm_chunk, "max_abs_err": err,
            "max_abs_logit": scale, "seconds": time.perf_counter() - t0}


def phase_families(dev, seed: int) -> None:
    """Phase 6b: the ssm, hybrid, audio and vlm families (no kernel of the
    port is on their paths, as no Pallas kernel is on the JAX package's;
    the launch counts are reset before the full-width runs and must stay
    0)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.skipper_match import kernel

    t_phase = time.perf_counter()
    metrics = {"smoke_card_vs_cpu_rel_err": families_small(dev, seed)}
    parts = {"smoke_s": time.perf_counter() - t_phase}
    flash.reset_launch_counts()
    kernel.reset_launch_counts()
    for arch in ("mamba2-130m", "zamba2-2.7b"):
        t0 = time.perf_counter()
        metrics[arch] = family_serve(arch, dev, seed)
        parts[arch] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    for arch in ("qwen2-vl-2b", "whisper-large-v3"):
        t0 = time.perf_counter()
        metrics[arch] = family_adapters(arch, dev, seed)
        parts[arch] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    launches = {**flash.launch_counts(), **kernel.launch_counts()}
    require(not any(launches.values()), f"a kernel launched on a family's "
            f"path: {launches}")
    metrics["kernel_launches"] = sum(launches.values())
    t0 = time.perf_counter()
    metrics["ssd_duality"] = {arch: ssd_duality(arch, dev, seed)
                              for arch in DUALITY}
    parts["duality_s"] = time.perf_counter() - t0
    metrics.update(parts=parts, phase_s=time.perf_counter() - t_phase)
    log("family serving metrics: " + json.dumps(metrics))


# ---------------------------------------------------------------- phase 7 --
#: the smoke configs whose train step on the card is held against the
#: port's CPU step, and the tolerance (relative to each leaf's largest
#: magnitude): both run f32 (TF32 off) and sum in other orders, a few 1e-7
#: apart on the CPU against the JAX package
TRAIN_SMOKE = ("llama3.2-1b", "granite-moe-3b-a800m") + FAMILY_ARCHS
TRAIN_TOL = 1e-4
#: the full-width training cell: granite-moe-3b-a800m, 3 steps of 2 rows
#: of 2048 tokens (one routing group of GROUP_TOKENS), seed 0. It had 4
#: steps before phase 6b: a host-bound step is 10-19 s, and one went to
#: keep the script near 1,000 s on a slow host (PERF.md section 7)
TRAIN_ARCH = "granite-moe-3b-a800m"
TRAIN_STEPS = 3
TRAIN_ROWS, TRAIN_SEQ = 2, 2048
#: the cell's learning rate. At the reference's default, 3e-4 after one
#: warmup step, this cell's loss rose over 4 steps (PERF.md,
#: granite-train); at the smoke size the JAX package's own bf16 steps do
#: not fall over 4 steps at 3e-4 either, and the port's equal them
#: (tests/test_torch_train.py). Every other field of the TrainConfig is
#: what ``launch.train.train`` builds.
TRAIN_LR = 1e-4
#: the step traced with torch.profiler (its time is not among the timed)
TRAIN_TRACED = 2
#: the checkpoint round trip: granite at full width and this depth
CKPT_LAYERS = 2
#: chunked against full-logits cross-entropy, bf16 at full width
CE_TOL = 1e-3
PACK_TILE = 256


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over want's largest magnitude."""
    want = want.detach().double()
    diff = (got.detach().double() - want).abs().max()
    return float(diff / torch.clamp(want.abs().max(), min=1e-30))


def step_within(got: dict, want: dict, mu: dict, lr: float,
                tcfg) -> Tuple[float, float]:
    """Parameters after one AdamW step from zero moments against another
    run's: within TRAIN_TOL of each leaf's largest magnitude, plus what a
    gradient error of TRAIN_TOL (of the leaf's largest gradient) moves the
    first update ``lr * g / (|g| + 1e-8)``, which divides each gradient by
    its own magnitude. ``g`` (clipped) is ``mu / (1 - beta1)``. Returns
    the largest relative error and the largest share of its bound."""
    worst, share = 0.0, 0.0
    for k, b in want.items():
        a, b = got[k].detach().double().cpu(), b.detach().double().cpu()
        g = mu[k].double().cpu() / (1 - tcfg.beta1)
        dg = TRAIN_TOL * g.abs().max()
        slack = lr * torch.clamp(
            dg / (torch.clamp(g.abs() - dg, min=0.0) + 1e-8), max=2.0)
        bound = TRAIN_TOL * b.abs().max() + slack
        d = (a - b).abs()
        worst = max(worst, rel_err(a, b))
        share = max(share, float((d / bound).max()))
        require(bool((d <= bound).all()), f"parameter {k} after one step: "
                f"the card and the CPU disagree beyond the bound")
    return worst, share


def train_small(dev, seed: int) -> dict:
    """Phase 7a: one ``train_step`` on the card against the port's CPU step
    on the same weights and batch, on each smoke config in f32."""
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.launch import adapters
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    out = {}
    for arch in TRAIN_SMOKE:
        cfg = get_smoke_config(arch)
        tcfg = TrainConfig(total_steps=10, warmup_steps=2)
        batch = family_batch(cfg, seed, 2, 32, "cpu", mask=True)
        runs = {}
        for d in ("cpu", dev):
            model = adapters.init_fn(torch.Generator().manual_seed(seed),
                                     cfg).to(d)
            opt = adamw.init_state(dict(model.named_parameters()), tcfg)
            opt, metrics = make_train_step(cfg, tcfg)(
                model, opt, {k: v.to(d) for k, v in batch.items()})
            runs[str(d)] = (dict(model.named_parameters()), opt,
                            {k: float(v) for k, v in metrics.items()})
        (p0, o0, m0), (p1, o1, m1) = runs["cpu"], runs[str(dev)]
        loss_err = abs(m1["loss"] - m0["loss"]) / abs(m0["loss"])
        gn_err = abs(m1["grad_norm"] - m0["grad_norm"]) / m0["grad_norm"]
        require(loss_err <= TRAIN_TOL and gn_err <= TRAIN_TOL,
                f"{cfg.name}: loss or grad norm on the card differs from "
                f"the CPU ({loss_err}, {gn_err})")
        mom = max(rel_err(a[k].cpu(), b[k])
                  for a, b in ((o1.mu, o0.mu), (o1.nu, o0.nu)) for k in b)
        require(mom <= TRAIN_TOL, f"{cfg.name}: moments differ ({mom})")
        worst, share = step_within(p1, p0, o0.mu, m0["lr"], tcfg)
        out[cfg.name] = {"loss_rel_err": loss_err, "grad_norm_rel_err":
                         gn_err, "moments_rel_err": mom,
                         "params_rel_err": worst,
                         "params_share_of_bound": share}
        log(f"train step {cfg.name}: card and CPU agree (loss "
            f"{m1['loss']:.6f} / {m0['loss']:.6f}, grad norm rel "
            f"{gn_err:.2e}, moments {mom:.2e}, parameters {worst:.2e}, "
            f"{share:.3f} of the bound)")
    return out


def packer_kernel_check(step: int, dcfg, dev):
    """Phase 7b: the packer's global-tier launch on ``step``'s edges
    against ``ref.ref_skipper`` on the same tiles, bit for bit (mask,
    state, conflicts). Returns ``(ut, vt, n, err)``: ``err`` is the
    largest difference from ``ref_skipper``."""
    from repro_torch.core.skipper import stream_tiles
    from repro_torch.data import documents_for_step
    from repro_torch.data.packing import _candidate_edges
    from repro_torch.graphs.types import EdgeList
    from repro_torch.kernels.skipper_match import ref

    # the candidate edges of the step's documents, as pack_documents
    # builds them
    docs = documents_for_step(step, dcfg, dcfg.batch_per_host * 2)
    u, v = _candidate_edges(np.asarray([len(d) for d in docs]),
                            dcfg.seq_len)
    n = len(docs)
    e = EdgeList(torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev), n)
    ut, vt = stream_tiles(e, PACK_TILE)
    row, matched, conflicts = raw_kernel(ut, vt, n, None)
    st = torch.zeros(n, dtype=torch.uint8, device=dev)
    want = (st, *ref.ref_skipper(st, ut, vt))
    err = max_err((row, want[0]), (matched, want[1]), (conflicts, want[2]))
    require(err == 0, f"packer step {step}: the global-tier launch differs "
            f"from ref_skipper ({err})")
    return ut, vt, n, err


def ce_check(model, batch, cfg, tcfg) -> dict:
    """At the first step: ``chunked_ce`` against ``cross_entropy`` on the
    whole logits of the same forward (no grad)."""
    from repro_torch.launch import adapters
    from repro_torch.launch.steps import chunked_ce, cross_entropy
    from repro_torch.models import layers as L

    with torch.no_grad():
        hidden, head, tr, targets, mask = adapters.train_hidden(
            model, batch, cfg)
        chunked = float(chunked_ce(hidden, head, tr, targets, mask,
                                   tcfg.z_loss))
        full = float(cross_entropy(L.lm_head(hidden, head, transpose=tr),
                                   targets, mask, tcfg.z_loss))
    err = abs(chunked - full) / abs(full)
    require(err <= CE_TOL, f"chunked_ce {chunked} and cross_entropy {full} "
            f"differ by {err:.2e} (over {CE_TOL})")
    return {"chunked_ce": chunked, "full_logits_ce": full,
            "ce_rel_err": err}


def profile_train_step(step_fn, model, opt, batch) -> Tuple[object, dict]:
    """One train step traced with ``torch.profiler`` (device activity
    only: the step launches about 700,000 kernels, and host events would
    slow it further): the device's busy time, its share of the traced wall
    time (the tracing slows the host, so this share is a floor) and the
    kernels that take its time. The raw events are summed directly:
    ``key_averages`` takes minutes over a trace this long."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, metrics = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        wall_ns = (time.perf_counter() - t0) * 1e9
    t0 = time.perf_counter()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    rows = sorted(((ns, k, n) for k, (ns, n) in by_name.items()),
                  reverse=True)
    out = {"traced_step_ms": wall_ns / 1e6,
           "trace_summary_s": time.perf_counter() - t0}
    if not rows:
        log("profiler: no device time recorded; busy share not measured")
        return (opt, metrics), dict(out, device_busy_share=None)
    busy_ns = sum(r[0] for r in rows)
    return (opt, metrics), dict(
        out, device_busy_ms=busy_ns / 1e6,
        device_busy_share=busy_ns / wall_ns,
        device_launches=sum(r[2] for r in rows),
        top_device_kernels=[{"name": k[:80], "ms": ns / 1e6, "launches": n}
                            for ns, k, n in rows[:8]])


def train_full(dev) -> Tuple[dict, dict]:
    """Phase 7c (with 7b at every step): granite-moe-3b-a800m at full width
    and depth trains TRAIN_STEPS steps through the train path's own
    ``TrainConfig``, step function and batches, the launch counts reset
    just before. Returns ``(metrics, packer)``: the packer's tiles, launch
    count and largest difference from ``ref_skipper`` for the kernels
    line."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.kernels.skipper_match import kernel
    from repro_torch.launch import adapters
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build_batch, train_config
    from repro_torch.optim import adamw

    cfg = get_config(TRAIN_ARCH)
    require(cfg.dtype == "bfloat16" and cfg.remat
            and cfg.moe_router == "skipper", f"{TRAIN_ARCH}: not bf16, "
            "remat and the Skipper router")
    # as launch.train.train builds them
    tcfg = train_config(TRAIN_STEPS, learning_rate=TRAIN_LR)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      batch_per_host=TRAIN_ROWS)
    t0 = time.perf_counter()
    model = adapters.init_fn(torch.Generator(device=dev).manual_seed(
        tcfg.seed), cfg)
    opt = adamw.init_state(dict(model.named_parameters()), tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step_fn = make_train_step(cfg, tcfg)
    metrics = {"arch": TRAIN_ARCH, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "experts": cfg.num_experts,
               "top_k": cfg.num_experts_per_tok, "dtype": cfg.dtype,
               "remat": cfg.remat, "router": cfg.moe_router,
               "params": n_params, "rows": TRAIN_ROWS, "seq": TRAIN_SEQ,
               "tokens_per_step": TRAIN_ROWS * TRAIN_SEQ, "init_s": init_s}
    losses, gnorms, step_ms, bmatch_ms, packs = [], [], [], [], []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launch_counts()
    for step in range(TRAIN_STEPS):
        want = batch_for_step(step, dcfg, device="cpu")
        if step == TRAIN_TRACED:
            batch = build_batch(cfg, dcfg, step, dev)
            (opt, m), prof = profile_train_step(step_fn, model, opt, batch)
            metrics.update(prof)
        else:
            with BmatchTimer(select=lambda kw: True) as timer:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = build_batch(cfg, dcfg, step, dev)
                if step == 0:
                    # outside the timed step: the same forward, no grad
                    t_ce = time.perf_counter()
                    metrics.update(ce_check(model, batch, cfg, tcfg))
                    t0 += time.perf_counter() - t_ce
                opt, m = step_fn(model, opt, batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            bmatch_ms.append(timer.seconds() * 1e3)
            if step == 1:      # step 0 also ran the cross-entropy check
                metrics["bmatch_calls_per_step"] = len(timer.events)
        got = (batch["tokens"].cpu().numpy(), batch["mask"].cpu().numpy())
        require(np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1]),
                f"packer step {step}: the card's rows differ from the CPU's")
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        require(np.isfinite(losses[-1]) and np.isfinite(gnorms[-1]),
                f"step {step}: loss {losses[-1]}, grad norm {gnorms[-1]}")
        packs.append(float(batch["mask"].float().mean()))
        log(f"train step {step}: loss {losses[-1]:.4f} grad norm "
            f"{gnorms[-1]:.3f} lr {float(m['lr']):.3e}"
            + (f", {step_ms[-1]:.1f} ms" if step != TRAIN_TRACED else
               " (traced)"))
    launches = kernel.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    require(launches[ASYNC] == TRAIN_STEPS, f"the packer's global tier "
            f"launched {launches[ASYNC]} times in {TRAIN_STEPS} steps")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(abs(metrics["chunked_ce"] - losses[0]) / losses[0] <= CE_TOL,
            "the first step's loss is not its chunked cross-entropy")
    # 7b: each step's packer launch against ref_skipper (outside the run)
    tiles = [packer_kernel_check(step, dcfg, dev)
             for step in range(TRAIN_STEPS)]
    log(f"packer: {TRAIN_STEPS} steps' global-tier launches bit-equal to "
        "ref_skipper and the card's rows to the CPU's")
    timed = step_ms[1:]          # the first step warms up
    metrics.update({
        "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
        "step_ms_steady": sum(timed) / len(timed),
        "tokens_per_s": TRAIN_ROWS * TRAIN_SEQ / (sum(timed) / len(timed))
        * 1e3,
        "bmatch_ms": bmatch_ms,
        "bmatch_share": sum(bmatch_ms[1:]) / sum(timed),
        "learning_rate": tcfg.learning_rate, "seed": tcfg.seed,
        "peak_device_bytes": peak, "packing_efficiency": packs,
        "launch_counts": launches})
    del model, opt, batch
    torch.cuda.empty_cache()
    return metrics, {"tiles": [t[:3] for t in tiles],
                     "max_abs_err": max(t[3] for t in tiles),
                     "launches": launches[ASYNC]}


def train_checkpoint(dev, seed: int) -> dict:
    """Phase 7d: granite at full width and CKPT_LAYERS layers, two steps,
    an asynchronous save, a restore into a fresh model (parameters and
    both moments bit-equal to the live ones), then the next step from both
    (the loss within TRAIN_TOL; parameters and moments compared)."""
    import tempfile

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch import adapters
    from repro_torch.launch import train as T
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=CKPT_LAYERS)
    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=1, seed=seed)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      batch_per_host=TRAIN_ROWS)
    step_fn = make_train_step(cfg, tcfg)

    def fresh(s):
        model = adapters.init_fn(torch.Generator(device=dev).manual_seed(s),
                                 cfg)
        return model, adamw.init_state(dict(model.named_parameters()), tcfg)

    live, opt = fresh(seed)
    for step in range(2):
        opt, _ = step_fn(live, opt, T.build_batch(cfg, dcfg, step, dev))
    out = {"layers": CKPT_LAYERS,
           "params": sum(p.numel() for p in live.parameters())}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        ck = Checkpointer(d)
        t0 = time.perf_counter()
        T.save(ck, 2, live, opt, cfg)
        out["save_host_copy_s"] = time.perf_counter() - t0
        ck.wait()
        out["save_s"] = time.perf_counter() - t0
        out["bytes_on_disk"] = sum(f.stat().st_size
                                   for f in Path(d).rglob("*") if f.is_file())
        restored, ropt = fresh(seed + 1)
        t0 = time.perf_counter()
        meta = T.restore(ck, None, restored, ropt, cfg)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
    require(meta["step"] == 2 and int(ropt.step) == int(opt.step) == 2,
            "restore: wrong step")
    live_p = dict(live.named_parameters())
    for k, p in restored.named_parameters():
        for a, b, what in ((p, live_p[k], "parameter"),
                           (ropt.mu[k], opt.mu[k], "first moment"),
                           (ropt.nu[k], opt.nu[k], "second moment")):
            require(a.dtype == b.dtype and torch.equal(a, b),
                    f"restore: {what} {k} is not bit-equal to the live one")
    batch = T.build_batch(cfg, dcfg, 2, dev)
    opt, m_live = step_fn(live, opt, batch)
    ropt, m_rest = step_fn(restored, ropt, batch)
    loss_err = abs(float(m_rest["loss"]) - float(m_live["loss"])) / abs(
        float(m_live["loss"]))
    require(loss_err <= TRAIN_TOL, f"the step after the restore differs "
            f"from the live one ({loss_err})")
    diffs = [rel_err(a, b) for a, b in zip(restored.parameters(),
                                           live.parameters())]
    out.update({"next_loss_rel_err": loss_err,
                "next_step_params_rel_err": max(diffs),
                "next_step_bit_equal": all(d == 0 for d in diffs)})
    log(f"checkpoint: {out['bytes_on_disk']:,} bytes saved in "
        f"{out['save_s']:.1f} s, restored in {out['restore_s']:.1f} s, "
        "parameters and both moments bit-equal; next step loss rel "
        f"{loss_err:.2e}, parameters rel {max(diffs):.2e}")
    del live, restored, opt, ropt
    torch.cuda.empty_cache()
    return out


def phase_train(dev, seed: int) -> dict:
    """Phase 7: the training path. Returns the kernels-line entry of the
    global tier on the packer path."""
    from repro_torch.core.statespec import StateSpec
    from repro_torch.kernels.skipper_match import kernel, ref
    from repro_torch.roofline import h100

    t_phase = time.perf_counter()
    small = train_small(dev, seed)
    parts = {"smoke_s": time.perf_counter() - t_phase}
    metrics, packer = train_full(dev)
    parts["full_width_s"] = time.perf_counter() - t_phase - sum(
        parts.values())
    ckpt = train_checkpoint(dev, seed)
    parts["checkpoint_s"] = time.perf_counter() - t_phase - sum(
        parts.values())
    # the packer's kernel alone and its plain version, on the last step's
    # tiles (launches here are not the run's)
    ut, vt, n = packer["tiles"][-1]
    k_ms, _ = cuda_time(lambda: raw_kernel(ut, vt, n, None), reps=20)

    def plain():
        st = torch.zeros(n, dtype=torch.uint8, device=dev)
        return ref.ref_skipper(st, ut, vt)

    plain_ms, _ = cuda_time(plain, reps=3)
    spec = StateSpec.u8()
    bound = h100.stream_bytes(ut.shape[0], ut.shape[1], n, spec)
    if metrics.get("device_busy_ms") is not None:
        # the traced step's device time over an untraced step's wall time
        metrics["device_busy_share_of_steady_step"] = (
            metrics["device_busy_ms"] / metrics["step_ms_steady"])
    metrics.update({"smoke_steps": small, "checkpoint": ckpt,
                    "packer_tiles": int(ut.shape[0]), "packer_vertices": n,
                    "packer_edges": [int((t[0] >= 0).sum())
                                     for t in packer["tiles"]],
                    "packer_kernel_ms": k_ms, "packer_plain_ms": plain_ms,
                    "parts": parts,
                    "phase_s": time.perf_counter() - t_phase})
    log("train metrics: " + json.dumps(metrics))
    return {"name": ASYNC, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[ASYNC],
            "path": "pack_documents (train data, via skipper)",
            "launches": packer["launches"], "launches_per_step": 1,
            "max_abs_err": packer["max_abs_err"], "ms": k_ms,
            "plain_ms": plain_ms,
            "plain_case": f"ref_skipper on the card, the last step's "
                          f"{ut.shape[0]} tile(s) of {ut.shape[1]} over "
                          f"{n} documents",
            "bound_ms": h100.bytes_ms(bound), "bound_by": "bytes",
            "library_ms": None}


# ---------------------------------------------------------------- phase 8 --
#: the two architectures the sharding layer brought in, at full width cut
#: to this depth on one card (their bf16 weights whole: about 810 GB and
#: 220 GB; at two layers 21.3 GB and 10.4 GB)
SHARD_ARCHS = ("llama3-405b", "qwen1.5-110b")
SHARD_LAYERS = 2
SHARD_SERVE = dict(num_requests=1, slots=1, prompt_len=512, max_new=8)
#: the training step: qwen1.5-110b, one row of 2048 tokens, seed 0
SHARD_TRAIN = dict(steps=1, batch_size=1, seq_len=2048)


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest distance in bf16 steps between two bf16 tensors (their bit
    patterns as ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(got) - ordered(want)).abs().max())


def shard_train(dev) -> dict:
    """Phase 8(d): one qwen1.5-110b step at SHARD_LAYERS layers, without
    a process group and then on a one-rank NCCL group; the two held
    within one bf16 step."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.skipper_match import kernel
    from repro_torch.launch.train import train

    arch = SHARD_ARCHS[1]
    cfg = get_config(arch)
    require(cfg.opt_state_dtype == "bfloat16", f"{arch}: moments not bf16")
    kw = dict(SHARD_TRAIN, ckpt_dir=None, device=dev, layers=SHARD_LAYERS,
              log_every=1000, return_params=True)
    out = {"arch": arch, "layers": SHARD_LAYERS, **SHARD_TRAIN}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0, want = train(arch, False, **kw)
    torch.cuda.synchronize()
    out["unsharded_s"] = time.perf_counter() - t0
    out["unsharded_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        kernel.reset_launch_counts()
        t0 = time.perf_counter()
        loss1, got = train(arch, False, **kw)
        torch.cuda.synchronize()
        out["sharded_s"] = time.perf_counter() - t0
        launches = kernel.launch_counts()
    finally:
        dist.destroy_process_group()
    out["sharded_peak_bytes"] = torch.cuda.max_memory_allocated()
    require(launches[ASYNC] >= SHARD_TRAIN["steps"], f"the packer's global "
            f"tier launched {launches[ASYNC]} times in the sharded step")
    require(all(np.isfinite(loss0 + loss1)), f"losses {loss0} {loss1}")
    require(set(got) == set(want), "the sharded run's parameters differ in "
            "keys")
    steps = {k: bf16_steps(got[k], want[k]) for k in want}
    worst = max(steps, key=steps.get)
    loss_step = abs(loss1[0] - loss0[0]) / (2.0 ** (np.floor(np.log2(
        abs(loss0[0]))) - 7))
    out.update(losses_unsharded=loss0, losses_sharded=loss1,
               loss_diff=abs(loss1[0] - loss0[0]),
               loss_diff_bf16_steps=loss_step,
               param_bf16_steps_max=steps[worst], param_worst=worst,
               params=sum(t.numel() for t in want.values()),
               packer_launches=launches[ASYNC])
    log(f"sharded train ({arch}, {SHARD_LAYERS} layers, 1 x "
        f"{SHARD_TRAIN['seq_len']}): loss {loss1[0]:.6f} against "
        f"{loss0[0]:.6f} unsharded ({loss_step:.3f} bf16 steps); "
        f"largest parameter difference {steps[worst]} bf16 step(s) "
        f"({worst}); {launches[ASYNC]} packer launch(es)")
    require(loss_step <= 1 and steps[worst] <= 1, "the sharded step is "
            "not within one bf16 step of the unsharded one")
    del want, got
    torch.cuda.empty_cache()
    return out


def phase_sharding(dev, seed: int, smi: str) -> None:
    """Phase 8: the dry-run, the two sharded architectures' smoke configs
    card against CPU, their serving at full width and SHARD_LAYERS
    layers, and the sharded training step (see the module's
    docstring)."""
    from repro_torch.configs import get_config, runnable_cells
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import serve

    t_phase = time.perf_counter()
    parts = {}
    recs = [dryrun.run_cell(arch, shape, mp, force=True, write=False)
            for arch, shapes in runnable_cells().items() for shape in shapes
            for mp in (False, True)]
    for rec in recs:
        log("dry-run " + dryrun.line(rec))
    ok = [r for r in recs if r.get("ok")]
    fits = [r for r in ok if r["fits_hbm"]]
    port_fits = [r for r in ok if r["port"]["runs"] and r["port"]["fits"]]
    log(f"dry-run: {len(ok)} of {len(recs)} cells reckoned; in the "
        f"reference's layout {len(fits)} fit the card's "
        f"{ok[0]['hbm_capacity_bytes'] if ok else 0} bytes, in the port's "
        f"own step {len(port_fits)}")
    require(len(ok) == len(recs), "a dry-run cell failed")
    parts["dryrun_s"] = time.perf_counter() - t_phase

    def cell(r):
        return f"{r['arch']}/{r['shape']}/{r['mesh']}"

    metrics = {"dryrun_cells": len(recs), "dryrun_ok": len(ok),
               "dryrun_fit": len(fits), "dryrun_port_fit": len(port_fits),
               "dryrun_not_fitting": [cell(r) for r in ok
                                      if not r["fits_hbm"]],
               "dryrun_port_not_fitting": [cell(r) for r in ok
                                           if r not in port_fits]}
    t0 = time.perf_counter()
    metrics["smoke_card_vs_cpu_rel_err"] = families_small(dev, seed,
                                                          SHARD_ARCHS)
    parts["smoke_s"] = time.perf_counter() - t0
    for arch in SHARD_ARCHS:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Recorder() as rec:
            outputs, st = serve(arch, False, seed=seed, device=dev,
                                layers=SHARD_LAYERS, **SHARD_SERVE)
        require(rec.finite and rec.logit_calls > 0,
                f"{arch} serving: non-finite logits")
        require(len(outputs[0]) == SHARD_SERVE["max_new"]
                or outputs[0][-1] == 2, f"{arch}: the request stopped early")
        metrics[arch] = {
            "layers": SHARD_LAYERS, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, **SHARD_SERVE,
            "prefill_ms": 1e3 * st["prefill_s"][0],
            "decode_tokens_per_s": st["decoded"] / st["decode_s"],
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "tokens": outputs[0]}
        parts[arch] = time.perf_counter() - t0
        log(f"{arch} ({SHARD_LAYERS} layers, full width): prefill "
            f"{metrics[arch]['prefill_ms']:.1f} ms, decode "
            f"{metrics[arch]['decode_tokens_per_s']:.1f} tokens/s, peak "
            f"{metrics[arch]['peak_device_bytes'] / 1e9:.1f} GB")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    metrics["train"] = shard_train(dev)
    parts["train_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    metrics.update(parts=parts, phase_s=time.perf_counter() - t_phase,
                   device=smi)
    log("sharding metrics: " + json.dumps(metrics))
    log(smi)


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

    start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {name}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(smi)

    t0 = time.perf_counter()
    sources = (kernel.SOURCE, flash.SOURCE, flash.WGMMA_SOURCE,
               flash.TF32_SOURCE, mutations.SOURCE)
    built = _build.build(*sources)
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} sources")
    for info in built.values():
        log(f"  nvcc {info['seconds']:.1f} s -> {info['path']}")
        log(info["log"].strip())
    t0 = time.perf_counter()
    ptx = _build.build(*sources, ptx=True)
    for info in ptx.values():
        log(f"  nvcc -ptx {info['seconds']:.1f} s -> {info['path']}")
    log(f"ptx: {time.perf_counter() - t0:.1f} s")
    # what the redesigned kernels are built from, in their PTX
    for source, needed in (
            (flash.WGMMA_SOURCE, ("wgmma.mma_async", "cp.async.bulk.tensor",
                                  "mbarrier::complete_tx", "setmaxnreg")),
            (flash.TF32_SOURCE, ("f32.tf32.tf32", "cvt.rna.tf32.f32",
                                 "cp.async.bulk.tensor",
                                 "mbarrier::complete_tx", "setmaxnreg")),
            (kernel.SOURCE, ("cp.async.bulk.shared", "cp.async.ca.shared",
                             "mbarrier.try_wait"))):
        text = Path(str(ptx[str(source)]["path"])).read_text()
        counts = {w: text.count(w) for w in needed}
        log(f"  {Path(source).name} PTX: {counts}")
        require(all(counts.values()), f"{Path(source).name}: PTX lacks one "
                f"of {needed}")
    # ... and, in each instance of the asynchronous window tier, its own
    text = Path(str(ptx[str(kernel.SOURCE)]["path"])).read_text()
    bodies = ptx_entries(text, WINDOW_ASYNC)
    needed = ("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx",
              "cp.async.bulk.global.shared::cta", "cp.async.ca.shared",
              "cp.async.mbarrier.arrive", "mbarrier.try_wait.parity",
              "fence.proxy.async", "bar.red.or")
    for body in bodies:
        counts = {w: body.count(w) for w in needed}
        require(all(counts.values()), f"{WINDOW_ASYNC}: an instance's PTX "
                f"lacks one of {needed}: {counts}")
    log(f"  {WINDOW_ASYNC} PTX: {len(bodies)} instances, each with {needed}")
    require(len(bodies) == 4, f"{WINDOW_ASYNC}: {len(bodies)} instances in "
            "the PTX, not 4")

    worst = phase_small(dev)
    kernels, edges, phase4 = phase_full(dev, args.seed, args.scale, worst)
    kernels.append(phase_raw(dev, edges, args.seed, phase4["match_ms"]))
    kernels += phase_dist(dev, edges, phase4, DIST_BLOCK)
    del edges, phase4
    # after phase 4: the analyzer's serving census leaves cuBLAS's
    # workspace allocated, which phase 4's peak device memory would count
    kernels += phase_analysis(dev)
    kernels += phase_flash(dev, args.seed)
    phase_serve(dev, args.seed)
    phase_families(dev, args.seed)
    kernels.append(phase_train(dev, args.seed))
    phase_sharding(dev, args.seed, smi)
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
