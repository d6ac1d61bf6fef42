"""Analysis targets: every instance of the port's kernels and the entry
points that launch them (port of ``repro.analysis.targets``), at the
reference's canonical geometry (``targets.py:27-31``: tile 256, window
256, 4 windows, 2 tiles a window, seed 0).

* Kernel targets (:class:`KernelTarget`) name one template instance of a
  ``__global__`` function: the asynchronous window tier, the first window
  tier, the first global tier and the asynchronous global tier (its staged,
  its device-memory and its filtered instance, the last over one state row
  as the raw stream launches it) under each (state width, counter width)
  pair (the window tier's ring depth is a launch argument, so the shape
  rule adds no instance), the CUDA-core flash
  attention under each (dtype, head dim) the source builds, the bf16
  tensor-core flash attention under each head dim, and the three-term TF32
  flash attention and its pre-pass under each (head dim, dtype) they take.
  Each carries the dynamic shared memory its launch wrapper requests at
  ``scale`` times the canonical vertex count, at the same window and tile
  — what ``smem-budget`` holds independent of V —, the largest block its
  wrapper admits and its ``setmaxnreg`` shares (``registers``), and, for
  the matcher's tiers, a launcher that ``tier-order`` runs against the
  plain version.
* Entry targets (:class:`EntryTarget`) run an entry point once on the card
  and report how many times each kernel launched (``kernel-census``):
  ``skipper_match``, the raw-stream ``skipper``, ``flash_attention``, the
  serving decode step, and ``distributed_skipper`` on one rank on each
  schedule (``distributed_sharded``, ``distributed_dispersed``: two
  global-tier launches a round, the local pass and the replay).
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.statespec import StateSpec

# canonical geometry: small but structurally faithful
TILE = 256
WINDOW = 256
NUM_WINDOWS = 4
TILES_PER_WINDOW = 2
SEED = 0
#: flash attention's canonical shape (the reference's flash target)
FLASH_SHAPE = dict(b=1, hq=2, hkv=1, s=256, block=128)

#: template spelling of the StateSpec / torch dtype names
CPP_TYPES = {"uint8": "unsigned char", "int32": "int",
             "float32": "float", "bfloat16": "__nv_bfloat16"}


@dataclasses.dataclass(frozen=True)
class KernelTarget:
    """One template instance of a kernel.

    ``role`` is "window", "boundary", "row" (the global tier over one
    state row, every tile the pair (0, 0)) or "flash". ``threads`` is the
    block the analysis launches, ``max_threads`` the largest block its
    wrapper admits, and ``setmaxnreg`` the ``(registers, warpgroups)``
    pairs of a kernel whose warpgroups set their registers.
    ``dynamic_smem(scale)`` is the shared memory its wrapper requests at
    ``scale``x the canonical vertex count (same window and tile).
    ``launch`` runs it on CUDA tensors with the signature of
    ``kernel.window_tier`` (role "window") or ``kernel.boundary_tier``
    (roles "boundary" and "row"), minus ``spec``.
    """

    name: str
    source: Path
    kernel: str
    template: Tuple[str, ...]
    role: str
    threads: int
    dynamic_smem: Callable[[int], int]
    smem_claim: str = ""
    spec: Optional[StateSpec] = None
    launch: Optional[Callable] = None
    max_threads: int = 0
    setmaxnreg: Tuple[Tuple[int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class EntryTarget:
    """An entry point: ``run(device)`` calls it once and returns the
    launches of each kernel counter; ``expect`` is what they must be."""

    name: str
    run: Callable[[torch.device], Dict[str, int]]
    expect: Dict[str, int]


@functools.lru_cache(maxsize=None)
def canonical_graph(scale: int = 1):
    """The reference's canonical random graph: 4 * 256 * scale vertices,
    four edges a vertex, from seed 0."""
    from repro_torch.interop import edges_from_arrays

    rng = np.random.default_rng(SEED)
    n = NUM_WINDOWS * WINDOW * scale
    m = 4 * n
    u = rng.integers(0, n, m).astype(np.int32)
    v = rng.integers(0, n, m).astype(np.int32)
    return edges_from_arrays(u, v, n)


@functools.lru_cache(maxsize=None)
def canonical_schedule(scale: int = 1):
    from repro_torch.graphs.windows import build_window_schedule

    return build_window_schedule(canonical_graph(scale), WINDOW, TILE, True)


def _matcher_targets() -> List[KernelTarget]:
    from repro_torch.kernels.skipper_match import kernel

    out = []
    for vmem in ("uint8", "int32"):
        for counter in ("uint8", "int32"):
            spec = StateSpec(vmem=vmem, wire=vmem, counter=counter)
            tmpl = (CPP_TYPES[vmem], CPP_TYPES[counter])

            def window_smem(scale, spec=spec):
                s = canonical_schedule(scale)
                return kernel.window_tier_smem_bytes(s.window, s.tile_size,
                                                     spec)

            def window_async_smem(scale, spec=spec):
                s = canonical_schedule(scale)
                return kernel.window_async_smem_bytes(s.window, s.tile_size,
                                                      spec)

            def boundary_smem(scale):
                return kernel.boundary_smem_bytes(
                    canonical_schedule(scale).tile_size)

            def async_smem(scale, spec=spec, staged=True):
                s = canonical_schedule(scale)
                return kernel.boundary_async_smem_bytes(
                    s.window, s.tile_size, spec, staged)

            out.append(KernelTarget(
                name=f"window_async[{vmem},{counter}]",
                source=kernel.SOURCE, kernel=kernel.WINDOW_ASYNC,
                template=tmpl, role="window", threads=TILE,
                max_threads=kernel.MAX_THREADS,
                dynamic_smem=window_async_smem,
                smem_claim="O(window * sizeof(S) + stages * 8 * "
                           "stage_tiles * tile), independent of V: one "
                           "row's state and the ring of ids",
                spec=spec,
                launch=functools.partial(kernel.window_tier, spec=spec)))
            out.append(KernelTarget(
                name=f"window_tier[{vmem},{counter}]",
                source=kernel.SOURCE, kernel=kernel.WINDOW_TIER,
                template=tmpl, role="window", threads=TILE,
                max_threads=kernel.MAX_THREADS,
                dynamic_smem=window_smem,
                smem_claim="O(window * sizeof(S) + 9 * tile), independent "
                           "of V: one row's state and one tile's ids",
                spec=spec,
                launch=functools.partial(kernel.window_tier_sync,
                                         spec=spec)))
            out.append(KernelTarget(
                name=f"boundary[{vmem},{counter}]",
                source=kernel.SOURCE, kernel=kernel.BOUNDARY,
                template=tmpl, role="boundary", threads=TILE,
                max_threads=kernel.MAX_THREADS,
                dynamic_smem=boundary_smem,
                smem_claim="O(9 * tile), independent of V: state stays in "
                           "device memory",
                spec=spec,
                launch=functools.partial(kernel.boundary_tier_sync,
                                         spec=spec)))
            for instance, flag in (("staged", "1"), ("device", "0")):
                staged = instance == "staged"
                out.append(KernelTarget(
                    name=f"boundary_async[{vmem},{counter},{instance}]",
                    source=kernel.SOURCE, kernel=kernel.BOUNDARY_ASYNC,
                    template=tmpl + (flag,), role="boundary", threads=TILE,
                    max_threads=kernel.BOUNDARY_ASYNC_MAX_THREADS,
                    dynamic_smem=functools.partial(async_smem,
                                                   staged=staged),
                    smem_claim=(
                        "O(2 * window * sizeof(S) + ring * 8 * tile), "
                        "independent of V: the pair's two state rows and "
                        "the ring of ids" if staged else
                        "O((ring * 8 + lists * 16) * tile), independent "
                        "of V: the ring of ids and the read-ahead's commit "
                        "lists (the filter's 8 KiB is static); state stays "
                        "in device memory"),
                    spec=spec,
                    launch=functools.partial(kernel.boundary_tier,
                                             spec=spec, instance=instance)))
            out.append(KernelTarget(
                name=f"boundary_async[{vmem},{counter},filtered]",
                source=kernel.SOURCE, kernel=kernel.BOUNDARY_ASYNC,
                template=tmpl + ("2",), role="row",
                threads=kernel.FILTERED_THREADS,
                max_threads=kernel.FILTERED_THREADS,
                dynamic_smem=lambda scale: kernel.filtered_smem_bytes(),
                smem_claim="O(tables + lag): the in-order block's hash "
                           "tables and the pack's bases, independent of V "
                           "and of the tile; the ring lies in device memory",
                spec=spec,
                launch=functools.partial(kernel.boundary_tier, spec=spec,
                                         instance=kernel.FILTERED)))
    return out


def _flash_targets() -> List[KernelTarget]:
    from repro_torch.kernels.flash_attention import kernel as flash

    out = []
    for dtype in ("float32", "bfloat16"):
        for d in flash.HEAD_DIMS:
            def smem(scale, d=d):
                blk = min(FLASH_SHAPE["block"], FLASH_SHAPE["s"] * scale)
                return flash.smem_bytes(d, blk, blk)

            out.append(KernelTarget(
                name=f"flash[{dtype},{d}]", source=flash.SOURCE,
                kernel=flash.FLASH, template=(CPP_TYPES[dtype], str(d)),
                role="flash", threads=FLASH_SHAPE["block"]
                * flash.LANES_PER_ROW,
                max_threads=flash.MAX_BLOCK_Q * flash.LANES_PER_ROW,
                dynamic_smem=smem,
                smem_claim="O(block_k * D + block_q * block_k), independent "
                           "of S: one k and one v chunk and its scores"))
    for d in flash.WGMMA_HEAD_DIMS:
        out.append(KernelTarget(
            name=f"flash_wgmma[bfloat16,{d}]", source=flash.WGMMA_SOURCE,
            kernel=flash.FLASH_WGMMA, template=(str(d),), role="flash",
            threads=3 * 128, max_threads=3 * 128,
            setmaxnreg=((flash.WGMMA_PRODUCER_REGS, 1),
                        (flash.WGMMA_CONSUMER_REGS, 2)),
            dynamic_smem=lambda scale, d=d: flash.wgmma_smem_bytes(d),
            smem_claim="O(128 * D + 2 * stages * BK * D), independent of "
                       "S: the Q tile and the ring of K and V chunks"))
    for d, dtype in flash.TF32_INSTANCES:
        consumers = flash.TF32_GEOMETRY[d][0]
        threads = 128 * (1 + consumers)
        out.append(KernelTarget(
            name=f"flash_tf32x3[{dtype},{d}]", source=flash.TF32_SOURCE,
            kernel=flash.FLASH_TF32, template=(str(d), CPP_TYPES[dtype]),
            role="flash", threads=threads, max_threads=threads,
            setmaxnreg=flash.tf32_setmaxnreg(d),
            dynamic_smem=lambda scale, d=d: flash.tf32_smem_bytes(d),
            smem_claim="O(2 * rows * Dp + 4 * stages * BK * (Dp + D)) "
                       "floats, independent of S: the Q planes and the ring "
                       "of K and V^T planes"))
        out.append(KernelTarget(
            name=f"flash_split_tf32[{dtype},{d}]", source=flash.TF32_SOURCE,
            kernel=flash.FLASH_SPLIT, template=(CPP_TYPES[dtype], str(d)),
            role="flash", threads=flash.SPLIT_THREADS,
            max_threads=flash.SPLIT_THREADS,
            dynamic_smem=lambda scale: 0,
            smem_claim="static: one 32-key tile of V, hi and lo, for its "
                       "transpose"))
    return out


# ------------------------------------------------------------ entries ----

def _counts() -> Dict[str, int]:
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.skipper_match import kernel

    return {**kernel.launch_counts(), **flash.launch_counts()}


def _reset() -> None:
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.skipper_match import kernel

    kernel.reset_launch_counts()
    flash.reset_launch_counts()


def _run_skipper_match(device: torch.device) -> Dict[str, int]:
    from repro_torch.kernels.skipper_match import skipper_match

    edges = canonical_graph(1)
    _reset()
    skipper_match(edges, schedule=canonical_schedule(1), device=device)
    torch.cuda.synchronize(device)  # host-sync: ok — counts after the run
    return _counts()


def _run_skipper(device: torch.device) -> Dict[str, int]:
    """The raw-stream matcher on the canonical graph: its tiles go through
    the asynchronous global tier once, as one state row."""
    from repro_torch.core.skipper import skipper

    edges = canonical_graph(1)
    _reset()
    skipper(edges, tile_size=TILE, device=device)
    torch.cuda.synchronize(device)  # host-sync: ok — counts after the run
    return _counts()


#: the distributed targets' global-tier block and drain rounds (the
#: reference's ``targets.py`` traces the same: block 512, four drains)
DIST_BLOCK = 512
DIST_DRAINS = 4


def _dist_rounds(sharded: bool) -> int:
    """Rounds (dealt blocks and drains) of the one-rank distributed run on
    the canonical graph: each launches the global tier twice."""
    if sharded:
        dealt = -(-canonical_schedule(1).num_boundary_padded // DIST_BLOCK)
    else:
        dealt = -(-canonical_graph(1).num_edges // DIST_BLOCK)
    return dealt + DIST_DRAINS


def _run_distributed(device: torch.device, sharded: bool) -> Dict[str, int]:
    from repro_torch.core.distributed import distributed_skipper

    kw = dict(schedule=canonical_schedule(1)) if sharded else {}
    _reset()
    distributed_skipper(canonical_graph(1), block_size=DIST_BLOCK,
                        tile_size=TILE, drain_rounds=DIST_DRAINS,
                        device=device, **kw)
    torch.cuda.synchronize(device)  # host-sync: ok — counts after the run
    return _counts()


def _run_flash_attention(device: torch.device) -> Dict[str, int]:
    from repro_torch.kernels.flash_attention import flash_attention

    sh = FLASH_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn((sh["b"], sh["hq"], sh["s"], 128), generator=gen,
                    device=device, dtype=torch.bfloat16)
    kv = torch.randn((sh["b"], sh["hkv"], sh["s"], 128), generator=gen,
                     device=device, dtype=torch.bfloat16)
    _reset()
    flash_attention(q, kv, kv, causal=True, device=device)
    # f32 at the same shape: the three-term kernel after its pre-pass
    flash_attention(q.float(), kv.float(), kv.float(), causal=True,
                    device=device)
    torch.cuda.synchronize(device)  # host-sync: ok — counts after the run
    return _counts()


def _run_serve_decode_step(device: torch.device) -> Dict[str, int]:
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import adapters
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg = get_smoke_config("granite-moe-3b-a800m")
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = adapters.init_fn(gen, cfg)
    prompt = torch.randint(3, cfg.vocab_size, (1, 16), generator=gen,
                           device=device)
    logits, cache = make_prefill_step(cfg)(model, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    _reset()
    make_serve_step(cfg)(model, cache, tok)
    torch.cuda.synchronize(device)  # host-sync: ok — counts after the run
    return _counts()


def _entry_targets() -> List[EntryTarget]:
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.skipper_match import kernel

    return [
        EntryTarget("skipper_match", _run_skipper_match,
                    {kernel.WINDOW_ASYNC: 1, kernel.WINDOW_TIER: 0,
                     kernel.BOUNDARY_ASYNC: 1, kernel.BOUNDARY: 0,
                     flash.FLASH: 0, flash.FLASH_WGMMA: 0,
                     flash.FLASH_TF32: 0, flash.FLASH_SPLIT: 0}),
        EntryTarget("skipper", _run_skipper,
                    {kernel.BOUNDARY_ASYNC: 1, kernel.BOUNDARY: 0,
                     kernel.WINDOW_ASYNC: 0, kernel.WINDOW_TIER: 0,
                     flash.FLASH: 0, flash.FLASH_WGMMA: 0,
                     flash.FLASH_TF32: 0, flash.FLASH_SPLIT: 0}),
        EntryTarget("flash_attention", _run_flash_attention,
                    {flash.FLASH_WGMMA: 1, flash.FLASH_TF32: 1,
                     flash.FLASH_SPLIT: 1, flash.FLASH: 0,
                     kernel.WINDOW_ASYNC: 0, kernel.WINDOW_TIER: 0,
                     kernel.BOUNDARY: 0, kernel.BOUNDARY_ASYNC: 0}),
        EntryTarget("serve_decode_step", _run_serve_decode_step,
                    {flash.FLASH: 0, flash.FLASH_WGMMA: 0,
                     flash.FLASH_TF32: 0, flash.FLASH_SPLIT: 0}),
    ] + [
        EntryTarget(f"distributed_{kind}",
                    functools.partial(_run_distributed,
                                      sharded=kind == "sharded"),
                    {kernel.BOUNDARY_ASYNC: 2 * _dist_rounds(
                        kind == "sharded"),
                     kernel.WINDOW_ASYNC: int(kind == "sharded"),
                     kernel.WINDOW_TIER: 0, kernel.BOUNDARY: 0,
                     flash.FLASH: 0, flash.FLASH_WGMMA: 0,
                     flash.FLASH_TF32: 0, flash.FLASH_SPLIT: 0})
        for kind in ("sharded", "dispersed")
    ]


@functools.lru_cache(maxsize=None)
def _registry() -> Dict[str, object]:
    targets = _matcher_targets() + _flash_targets() + _entry_targets()
    return {t.name: t for t in targets}


def target_names() -> List[str]:
    return list(_registry())


def get_targets(names: Optional[List[str]] = None) -> List[object]:
    reg = _registry()
    if names is None:
        return list(reg.values())
    missing = [n for n in names if n not in reg]
    if missing:
        raise KeyError(
            f"unknown analysis target(s) {missing}; known: {sorted(reg)}")
    return [reg[n] for n in names]
