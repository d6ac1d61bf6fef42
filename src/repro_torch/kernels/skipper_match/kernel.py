"""Build, load and launch the two hand-written skipper_match CUDA kernels.

``csrc/skipper_match.cu`` holds the kernels with a plain C interface; it is
built and loaded through ``kernels/_build.py`` (nvcc for ``sm_90a`` into
``build/repro_torch/``, ``ctypes``).

Wrappers:

* :func:`window_tier` — ``skipper_window_tier_kernel``: one block per
  schedule row, the row's state in shared memory.
* :func:`boundary_tier` — ``skipper_boundary_kernel``: one persistent block
  over the global-tier tiles in schedule order, state in device memory.

Each wrapper takes CUDA tensors and launches its kernel on the current
stream, or raises; given CPU tensors it runs the plain version from
``ref.py``. It checks device, dtype, shape, contiguity, id ranges and the
shared-memory size, raises on a launch error, and adds one to its launch
count each time it launches the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.statespec import StateSpec, resolve as resolve_spec
from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES

SOURCE = Path(__file__).resolve().parent / "csrc" / "skipper_match.cu"

MAX_THREADS = 1024

WINDOW_TIER = "skipper_window_tier_kernel"
BOUNDARY = "skipper_boundary_kernel"

_LAUNCHES: Dict[str, int] = {WINDOW_TIER: 0, BOUNDARY: 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    for s in ("uint8", "int32"):
        for c in ("uint8", "int32"):
            fn = getattr(lib, f"skipper_window_tier_{s}_{c}")
            fn.argtypes = [_VP] * 6 + [_I] * 7 + [_VP]
            fn.restype = _I
            fn = getattr(lib, f"skipper_boundary_{s}_{c}")
            fn.argtypes = [_VP] * 7 + [_I] * 5 + [_VP]
            fn.restype = _I
    lib.skipper_error_string.argtypes = [_I]
    lib.skipper_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        msg = _library().skipper_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def window_tier_smem_bytes(window: int, tile_size: int,
                           spec: Optional[StateSpec] = None) -> int:
    """Dynamic shared memory of one window-tier block: the state row
    (padded to 4 bytes), then the tile's u and v ids and free flags
    (the layout of ``window_tier_smem`` in the CUDA source)."""
    spec = resolve_spec(spec)
    return -(-window * spec.vmem_bytes // 4) * 4 + 9 * tile_size


def boundary_smem_bytes(tile_size: int) -> int:
    """Dynamic shared memory of the global-tier block: the tile's u and v
    ids and free flags (``launch_boundary`` in the CUDA source requests
    ``9 * T``)."""
    return 9 * tile_size


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _ids_ok(u: torch.Tensor, v: torch.Tensor, hi_u: int,
            hi_v: int) -> torch.Tensor:
    """True iff every slot is padding (both ids -1) or has u in [0, hi_u)
    and v in [0, hi_v): the kernels index state with these ids."""
    pad = (u == -1) & (v == -1)
    return (pad | ((u >= 0) & (u < hi_u) & (v >= 0) & (v < hi_v))).all()


def _check_common(tensors, tile_size: int) -> None:
    dev = tensors[0].device
    for t in tensors:
        _require(t.device == dev, "all tensors must be on one device")
        _require(t.is_contiguous(), "tensors must be contiguous")
    _require(1 <= tile_size <= MAX_THREADS,
             f"tile_size must lie in [1, {MAX_THREADS}], got {tile_size}")


def window_tier(
    u_rows: torch.Tensor,
    v_rows: torch.Tensor,
    state_in: torch.Tensor,
    *,
    tile_size: int,
    vector_rounds: int = 1,
    fallback: bool = True,
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Window tier: row r's state starts from ``state_in[r]`` and its tiles
    are matched in order.

    u_rows, v_rows: int32[num_rows, tiles_per_row * tile_size] window-local
    ids, (-1, -1) padding. state_in: spec.vmem[num_rows, window].
    Returns ``(states spec.vmem[num_rows, window], matched, conflicts)``,
    matched/conflicts ``spec.counter`` of ``u_rows``'s shape.
    """
    spec = resolve_spec(spec)
    spec.validate_rounds(vector_rounds)
    _check_common((u_rows, v_rows, state_in), tile_size)
    _require(u_rows.dim() == 2 and u_rows.shape == v_rows.shape,
             "u_rows and v_rows must be 2-D of one shape")
    _require(u_rows.dtype == torch.int32 and v_rows.dtype == torch.int32,
             "u_rows and v_rows must be int32")
    num_rows, slots = u_rows.shape
    _require(slots % tile_size == 0,
             f"row length {slots} is not a multiple of tile_size {tile_size}")
    _require(state_in.dim() == 2 and state_in.shape[0] == num_rows,
             "state_in must be [num_rows, window]")
    _require(state_in.dtype == spec.vmem_dtype,
             f"state_in must be {spec.vmem_dtype} (spec.vmem)")
    window = state_in.shape[1]
    if u_rows.device.type == "cpu":
        from repro_torch.kernels.skipper_match.ref import ref_window_tier

        return ref_window_tier(u_rows, v_rows, state_in, tile_size=tile_size,
                               vector_rounds=vector_rounds,
                               fallback=fallback, spec=spec)
    _require(u_rows.device.type == "cuda", "tensors must be on CPU or CUDA")
    smem = window_tier_smem_bytes(window, tile_size, spec)
    _require(smem <= MAX_SMEM_BYTES,
             f"window tier needs {smem} B of shared memory per block "
             f"(window={window}, {spec.vmem} state, tile {tile_size}); "
             f"a block has {MAX_SMEM_BYTES} B")
    ids_ok = _ids_ok(u_rows, v_rows, window, window)
    _require(bool(ids_ok),  # host-sync: ok — ids index device memory
             f"edge ids out of range: ids must lie in [0, {window}), "
             "padding is (-1, -1)")
    states = torch.empty_like(state_in)
    matched = torch.empty(u_rows.shape, dtype=spec.counter_dtype,
                          device=u_rows.device)
    conflicts = torch.empty_like(matched)
    if num_rows == 0 or slots == 0:
        states.copy_(state_in)
        return states, matched, conflicts
    fn = getattr(_library(),
                 f"skipper_window_tier_{spec.vmem}_{spec.counter}")
    stream = torch.cuda.current_stream(u_rows.device).cuda_stream
    err = fn(u_rows.data_ptr(), v_rows.data_ptr(), state_in.data_ptr(),
             states.data_ptr(), matched.data_ptr(), conflicts.data_ptr(),
             num_rows, slots // tile_size, tile_size, window, vector_rounds,
             int(fallback), smem, stream)
    _check_launch(WINDOW_TIER, err)
    _LAUNCHES[WINDOW_TIER] += 1
    return states, matched, conflicts


def boundary_tier(
    state_rows: torch.Tensor,
    blk_u: torch.Tensor,
    blk_v: torch.Tensor,
    u_tiles: torch.Tensor,
    v_tiles: torch.Tensor,
    *,
    vector_rounds: int = 1,
    fallback: bool = True,
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global tier: the block-pair grouped tiles in schedule order, against
    ``state_rows`` spec.vmem[num_windows, window], updated **in place**.

    blk_u, blk_v: int32[num_tiles] pair rows; u_tiles, v_tiles:
    int32[num_tiles, T] offset-local ids (u in [0, W), v in [0, 2W)).
    Returns ``(matched, conflicts)``, both spec.counter[num_tiles, T].
    """
    spec = resolve_spec(spec)
    spec.validate_rounds(vector_rounds)
    _require(u_tiles.dim() == 2 and u_tiles.shape == v_tiles.shape,
             "u_tiles and v_tiles must be 2-D of one shape")
    num_tiles, tile_size = u_tiles.shape
    _check_common((state_rows, blk_u, blk_v, u_tiles, v_tiles), tile_size)
    for t in (blk_u, blk_v, u_tiles, v_tiles):
        _require(t.dtype == torch.int32, "ids and blocks must be int32")
    _require(blk_u.shape == (num_tiles,) and blk_v.shape == (num_tiles,),
             "blk_u and blk_v must be [num_tiles]")
    _require(state_rows.dim() == 2, "state_rows must be [num_windows, W]")
    _require(state_rows.dtype == spec.vmem_dtype,
             f"state_rows must be {spec.vmem_dtype} (spec.vmem)")
    num_windows, window = state_rows.shape
    if state_rows.device.type == "cpu":
        from repro_torch.kernels.skipper_match.ref import ref_boundary_pass

        return ref_boundary_pass(state_rows, blk_u, blk_v, u_tiles, v_tiles,
                                 vector_rounds=vector_rounds,
                                 fallback=fallback, spec=spec)
    _require(state_rows.device.type == "cuda",
             "tensors must be on CPU or CUDA")
    matched = torch.empty(u_tiles.shape, dtype=spec.counter_dtype,
                          device=u_tiles.device)
    conflicts = torch.empty_like(matched)
    if num_tiles == 0:
        return matched, conflicts
    blocks_ok = ((blk_u >= 0) & (blk_u < num_windows) & (blk_v >= 0)
                 & (blk_v < num_windows)).all()
    ids_ok = _ids_ok(u_tiles, v_tiles, window, 2 * window) & blocks_ok
    _require(bool(ids_ok),  # host-sync: ok — ids index device memory
             f"ids out of range: u must lie in [0, {window}), v in "
             f"[0, {2 * window}), padding is (-1, -1), pair blocks in "
             f"[0, {num_windows})")
    fn = getattr(_library(), f"skipper_boundary_{spec.vmem}_{spec.counter}")
    stream = torch.cuda.current_stream(u_tiles.device).cuda_stream
    err = fn(blk_u.data_ptr(), blk_v.data_ptr(), u_tiles.data_ptr(),
             v_tiles.data_ptr(), state_rows.data_ptr(), matched.data_ptr(),
             conflicts.data_ptr(), num_tiles, tile_size, window,
             vector_rounds, int(fallback), stream)
    _check_launch(BOUNDARY, err)
    _LAUNCHES[BOUNDARY] += 1
    return matched, conflicts
