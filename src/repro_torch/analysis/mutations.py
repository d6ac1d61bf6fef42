"""Seeded mutants that prove the analyzer has teeth (port of
``repro.analysis.mutations``; the registry keeps its names).

Each kernel mutant is a hand-written CUDA copy of one of the matcher's
production kernels (``csrc/mutants.cu``) with exactly ONE line group
changed and marked ``// MUTATION:``, breaking the Hopper form of the
invariant the reference's mutant broke:

* ``dropped_dma_wait``      — ``skipper_window_tier_kernel`` without the
  barrier after the state row's load: the first tile reads shared state
  before every lane stored it (``smem-barrier``). Racy by design, so it
  has no plain version; it is held against the production one only to
  report what the race did.
* ``swapped_writeback``     — ``skipper_boundary_kernel`` walking the
  global tier from its last tile to its first (``tier-order``). Its plain
  version is ``ref.ref_boundary_pass`` over the reversed tile order.
* ``dynamic_gather``        — ``skipper_boundary_kernel`` whose slot ids
  pass through a per-thread array indexed at run time, which ptxas puts on
  the stack (``local-memory``). Its plain version is the production one:
  the outputs agree bit for bit, so only the analyzer sees the hazard.
* ``hardcoded_state_dtype`` — a SOURCE fixture (a string, written to a
  temp file at analysis time — as a real module the tree-wide state-dtype
  scan would flag the repo itself) that allocates a state buffer with a
  literal torch dtype instead of ``StateSpec`` (``state-dtype``).

The kernel mutants run at the default StateSpec (uint8 state and
counters). Their launchers count launches like the production wrappers.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.core.statespec import DEFAULT

SOURCE = Path(__file__).resolve().parent / "csrc" / "mutants.cu"

_VP = ctypes.c_void_p
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class Mutant:
    kernel: str         # the mutant's __global__ function in mutants.cu
    copy_of: str        # the production kernel it copies
    role: str           # "window" or "boundary"
    rule: str           # the rule that must report it at ERROR
    replaces: str       # the reference mutant, file:line


KERNEL_MUTATIONS: Dict[str, Mutant] = {
    "dropped_dma_wait": Mutant(
        "mutant_dropped_dma_wait_kernel", "skipper_window_tier_kernel",
        "window", "smem-barrier",
        "src/repro/analysis/mutations.py:42"),
    "swapped_writeback": Mutant(
        "mutant_swapped_writeback_kernel", "skipper_boundary_kernel",
        "boundary", "tier-order",
        "src/repro/analysis/mutations.py:86"),
    "dynamic_gather": Mutant(
        "mutant_dynamic_gather_kernel", "skipper_boundary_kernel",
        "boundary", "local-memory",
        "src/repro/analysis/mutations.py:132"),
}

# Source-rule fixture: a literal state dtype outside core/statespec. Kept as
# a string so the repo-wide state-dtype scan stays clean; the runner writes
# it to a temp file and lints that.
HARDCODED_STATE_DTYPE_SRC = '''\
"""Mutation fixture: hard-coded state dtype (must trip the state-dtype rule)."""
import torch


def make_state(num_vertices):
    state = torch.zeros((num_vertices,), dtype=torch.int32)
    return state
'''

SOURCE_MUTATIONS = {
    "hardcoded_state_dtype": HARDCODED_STATE_DTYPE_SRC,
}

#: the rule that must catch each mutant
EXPECTED_RULE = {**{k: m.rule for k, m in KERNEL_MUTATIONS.items()},
                 "hardcoded_state_dtype": "state-dtype"}

MUTATION_NAMES = sorted(KERNEL_MUTATIONS) + sorted(SOURCE_MUTATIONS)

_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_MUTATIONS}


def launch_counts() -> Dict[str, int]:
    """Launches per mutant kernel since the last reset."""
    return {KERNEL_MUTATIONS[n].kernel: c for n, c in _LAUNCHES.items()}


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    lib.mutant_dropped_dma_wait.argtypes = [_VP] * 6 + [_I] * 7 + [_VP]
    lib.mutant_dropped_dma_wait.restype = _I
    for name in ("swapped_writeback", "dynamic_gather"):
        fn = getattr(lib, f"mutant_{name}")
        fn.argtypes = [_VP] * 7 + [_I] * 5 + [_VP]
        fn.restype = _I
    lib.skipper_error_string.argtypes = [_I]
    lib.skipper_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    return _build.load(SOURCE, _declare)


def _check(name: str, role: str, state: torch.Tensor, ids) -> None:
    if KERNEL_MUTATIONS[name].role != role:
        raise ValueError(f"mutant {name!r} is a {KERNEL_MUTATIONS[name].role}"
                         f"-tier kernel")
    for t in (state, *ids):
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("mutants take contiguous CUDA tensors")
    if state.dtype != DEFAULT.vmem_dtype or any(
            t.dtype != torch.int32 for t in ids):
        raise ValueError(f"mutants take {DEFAULT.vmem_dtype} state and int32 "
                         "ids")


def _launched(name: str, err: int) -> None:
    if err != 0:
        msg = _library().skipper_error_string(err).decode()
        raise RuntimeError(f"mutant {name} launch failed: CUDA error {err} "
                           f"({msg})")
    _LAUNCHES[name] += 1


def window_tier(name: str, u_rows: torch.Tensor, v_rows: torch.Tensor,
                state_in: torch.Tensor, *, tile_size: int,
                vector_rounds: int = 1, fallback: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch a window-tier mutant as ``kernel.window_tier_sync`` launches
    the production kernel it copies (default StateSpec)."""
    from repro_torch.kernels.skipper_match import kernel

    _check(name, "window", state_in, (u_rows, v_rows))
    num_rows, slots = u_rows.shape
    window = state_in.shape[1]
    states = torch.empty_like(state_in)
    matched = torch.empty(u_rows.shape, dtype=DEFAULT.counter_dtype,
                          device=u_rows.device)
    conflicts = torch.empty_like(matched)
    smem = kernel.window_tier_smem_bytes(window, tile_size, DEFAULT)
    stream = torch.cuda.current_stream(u_rows.device).cuda_stream
    _launched(name, getattr(_library(), f"mutant_{name}")(
        u_rows.data_ptr(), v_rows.data_ptr(), state_in.data_ptr(),
        states.data_ptr(), matched.data_ptr(), conflicts.data_ptr(),
        num_rows, slots // tile_size, tile_size, window, vector_rounds,
        int(fallback), smem, stream))
    return states, matched, conflicts


def boundary_tier(name: str, state_rows: torch.Tensor, blk_u: torch.Tensor,
                  blk_v: torch.Tensor, u_tiles: torch.Tensor,
                  v_tiles: torch.Tensor, *, vector_rounds: int = 1,
                  fallback: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch a global-tier mutant as ``kernel.boundary_tier`` launches the
    production kernel (default StateSpec; ``state_rows`` in place)."""
    _check(name, "boundary", state_rows, (blk_u, blk_v, u_tiles, v_tiles))
    num_tiles, tile_size = u_tiles.shape
    matched = torch.empty(u_tiles.shape, dtype=DEFAULT.counter_dtype,
                          device=u_tiles.device)
    conflicts = torch.empty_like(matched)
    stream = torch.cuda.current_stream(u_tiles.device).cuda_stream
    _launched(name, getattr(_library(), f"mutant_{name}")(
        blk_u.data_ptr(), blk_v.data_ptr(), u_tiles.data_ptr(),
        v_tiles.data_ptr(), state_rows.data_ptr(), matched.data_ptr(),
        conflicts.data_ptr(), num_tiles, tile_size, state_rows.shape[1],
        vector_rounds, int(fallback), stream))
    return matched, conflicts


def plain(name: str, *args, **kw):
    """The plain PyTorch version a kernel mutant is held against, with
    the signature of its launcher: ``ref.ref_window_tier`` for
    ``dropped_dma_wait`` (the production plain version; the mutant races),
    ``ref.ref_boundary_pass`` for ``dynamic_gather``, and the same over the
    reversed tile order for ``swapped_writeback`` (outputs in the given
    tile order)."""
    from repro_torch.kernels.skipper_match import ref

    if name == "dropped_dma_wait":
        return ref.ref_window_tier(*args, spec=DEFAULT, **kw)
    if name == "dynamic_gather":
        return ref.ref_boundary_pass(*args, spec=DEFAULT, **kw)
    if name == "swapped_writeback":
        state_rows, *tiles = args
        flipped = [t.flip(0).contiguous() for t in tiles]
        matched, conflicts = ref.ref_boundary_pass(state_rows, *flipped,
                                                   spec=DEFAULT, **kw)
        return matched.flip(0), conflicts.flip(0)
    raise KeyError(f"unknown kernel mutation {name!r}")


def target(name: str):
    """The mutant as an analysis target (``targets.KernelTarget``)."""
    from repro_torch.analysis import targets
    from repro_torch.kernels.skipper_match import kernel

    m = KERNEL_MUTATIONS[name]
    t = targets.TILE

    def smem(scale):
        s = targets.canonical_schedule(scale)
        if m.role == "window":
            return kernel.window_tier_smem_bytes(s.window, s.tile_size,
                                                 DEFAULT)
        return kernel.boundary_smem_bytes(s.tile_size)

    launch = window_tier if m.role == "window" else boundary_tier
    return targets.KernelTarget(
        name=f"mutation:{name}", source=SOURCE, kernel=m.kernel,
        template=(targets.CPP_TYPES["uint8"],) * 2, role=m.role, threads=t,
        max_threads=kernel.MAX_THREADS, dynamic_smem=smem,
        smem_claim=f"as {m.copy_of}", spec=DEFAULT,
        launch=functools.partial(launch, name))
