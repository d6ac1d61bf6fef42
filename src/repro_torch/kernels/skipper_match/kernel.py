"""Build, load and launch the hand-written skipper_match CUDA kernels.

``csrc/skipper_match.cu`` holds the kernels with a plain C interface; it is
built and loaded through ``kernels/_build.py`` (nvcc for ``sm_90a`` into
``build/repro_torch/``, ``ctypes``).

Wrappers:

* :func:`window_tier` — ``skipper_window_async_kernel``, the main path's
  window tier: one block per schedule row, the row's state in shared
  memory, the ids fed ahead of use through a ring of asynchronous copies,
  dead stages passed with one barrier. The ring's depth follows the shape
  (:func:`window_ring_stages`); a shape whose ring does not fit beside the
  row takes ``skipper_window_tier_kernel`` (:func:`window_instance`).
* :func:`window_tier_sync` — ``skipper_window_tier_kernel``, the first
  window tier (ids read from device memory on each tile's chain), kept as
  the yardstick of the one above and as the body the ``dropped_dma_wait``
  canary copies.
* :func:`boundary_tier` — ``skipper_boundary_async_kernel``, the main
  path's global tier: one persistent block over the global-tier tiles in
  schedule order, the ids fed ahead of use through a ring of asynchronous
  copies; its ``staged`` instance keeps the pair's two state rows in shared
  memory, its ``device`` instance leaves the state in device memory. The
  shape picks the instance (:func:`boundary_instance`).
* :func:`boundary_tier_sync` — ``skipper_boundary_kernel``, the first
  global tier (ids and state read from device memory on each tile's
  chain), kept as the yardstick of the one above and as the body the
  analyzer's canaries copy.

:func:`window_tier` and :func:`boundary_tier` take CUDA tensors and launch
their kernel on the current stream, or raise; given CPU tensors they run
the plain version from ``ref.py``. The ``_sync`` wrappers take CUDA
tensors only. Each checks device, dtype, shape, contiguity, id ranges and
the shared-memory size, raises on a launch error, and adds one to its
kernel's launch count each time it launches it.
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
#: the largest tile ``skipper_boundary_async_kernel`` takes
#: (``kMaxAsyncBoundaryTile``: the block's registers); wider tiles take
#: ``skipper_boundary_kernel``
BOUNDARY_ASYNC_MAX_THREADS = 896

WINDOW_TIER = "skipper_window_tier_kernel"
WINDOW_ASYNC = "skipper_window_async_kernel"
BOUNDARY = "skipper_boundary_kernel"
BOUNDARY_ASYNC = "skipper_boundary_async_kernel"
#: the asynchronous window tier's ring: stages of consecutive tiles of a row
#: (``kWinGroup``), at most ``kWinMaxStages`` stages, each filled by bulk
#: copies
WINDOW_STAGE_TILES = 16
WINDOW_RING_STAGES = 8
#: its static shared memory: its mbarriers and, sized for ``MAX_THREADS``
#: lanes, the free flags, the warp counts, the free list and the warps'
#: tile bits (an upper bound: ptxas drops the free flags, which the
#: free-list test never reads)
WINDOW_ASYNC_STATIC_SMEM = (8 * (WINDOW_RING_STAGES + 1) + MAX_THREADS
                            + 4 * (32 + 2 * MAX_THREADS + 32))
#: the counters of its optional cycle profile (``profile=`` of
#: :func:`window_tier`): thread 0's clock64 cycles added over the stages and
#: the rows. ``stage_wait`` is the wait on the stage's mbarrier,
#: ``dead_test`` the slots' test and its barrier, ``tile_mask`` the warp
#: reductions of a live stage, ``tile_body`` the walked tiles' match_tile,
#: ``counters_release_refill`` the rest of the stage loop (counter stores,
#: the live stage's release barrier, lane 0's refill; the wrapper derives it
#: from ``total``), ``refill`` lane 0's refill issue alone (a part of the
#: former); ``dead_stages`` are stages passed with one barrier,
#: ``walked_tiles`` tiles with a free slot at their stage's test,
#: ``free_tiles`` those with a free lane at their own round 0
WINDOW_PROFILE_FIELDS = ("stage_wait", "dead_test", "tile_mask", "tile_body",
                         "counters_release_refill", "refill", "dead_stages",
                         "walked_tiles", "free_tiles",
                         "tile_body_in_free_tiles", "total")
#: the asynchronous global tier's ring: stages (``kRing``) of consecutive
#: tiles (``kGroup``), each stage filled by bulk copies
RING_STAGES = 4
TILES_PER_STAGE = 4
#: the two instances of the asynchronous global tier
INSTANCES = ("staged", "device")
#: static shared memory of the asynchronous global tier: its mbarriers and,
#: sized for ``MAX_THREADS`` lanes, the free flags and the free list
ASYNC_STATIC_SMEM = (8 * (2 * RING_STAGES + 1) + MAX_THREADS
                     + 4 * (32 + 2 * MAX_THREADS))
#: the counters of its optional cycle profile (``profile=`` of
#: :func:`boundary_tier`): thread 0's clock64 cycles summed over the tiles
PROFILE_FIELDS = ("wait_and_ids", "state_rows", "tile_body",
                  "counters_release_refill", "free_tiles",
                  "tile_body_in_free_tiles", "free_rounds", "total")

_LAUNCHES: Dict[str, int] = {WINDOW_TIER: 0, WINDOW_ASYNC: 0, BOUNDARY: 0,
                             BOUNDARY_ASYNC: 0}

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
            fn = getattr(lib, f"skipper_window_async_{s}_{c}")
            fn.argtypes = [_VP] * 6 + [_I] * 8 + [_VP] * 2
            fn.restype = _I
            fn = getattr(lib, f"skipper_boundary_{s}_{c}")
            fn.argtypes = [_VP] * 7 + [_I] * 5 + [_VP]
            fn.restype = _I
            fn = getattr(lib, f"skipper_boundary_async_{s}_{c}")
            fn.argtypes = [_VP] * 7 + [_I] * 7 + [_VP] * 2
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


def window_stage_bytes(tile_size: int) -> int:
    """One ring stage of the asynchronous window tier: the u and v ids of
    ``WINDOW_STAGE_TILES`` tiles (``win_stage_bytes`` in the CUDA
    source)."""
    return 8 * WINDOW_STAGE_TILES * tile_size


def window_async_smem_bytes(window: int, tile_size: int,
                            spec: Optional[StateSpec] = None,
                            stages: Optional[int] = None) -> int:
    """Dynamic shared memory of one asynchronous window-tier block
    (``window_async_smem`` in the CUDA source): the state row padded to 16
    bytes, then ``stages`` ring stages (by default the depth
    :func:`window_ring_stages` picks) of ``WINDOW_STAGE_TILES`` tiles' u
    and v ids. The kernel's static arrays
    (:data:`WINDOW_ASYNC_STATIC_SMEM`) come on top."""
    spec = resolve_spec(spec)
    if stages is None:
        stages = window_ring_stages(window, tile_size, spec)
    return (-(-window * spec.vmem_bytes // 16) * 16
            + stages * window_stage_bytes(tile_size))


def window_ring_stages(window: int, tile_size: int,
                       spec: Optional[StateSpec] = None) -> int:
    """The ring depth of the asynchronous window tier at this shape: as
    many stages as fit in a block's shared memory beside the state row and
    the static arrays, at most :data:`WINDOW_RING_STAGES`; 0 when not one
    fits (``legacy_i32()`` state above window 47,532 at tile 256)."""
    room = (MAX_SMEM_BYTES - WINDOW_ASYNC_STATIC_SMEM
            - window_async_smem_bytes(window, tile_size, spec, 0))
    return max(0, min(WINDOW_RING_STAGES,
                      room // window_stage_bytes(tile_size)))


def window_instance(window: int, tile_size: int,
                    spec: Optional[StateSpec] = None) -> str:
    """The window-tier kernel :func:`window_tier` launches at this shape:
    ``"async"`` (``skipper_window_async_kernel``) when the state row is a
    whole number of 16-byte bulk-copy units and a ring of at least one
    stage fits beside it, else ``"sync"`` (``skipper_window_tier_kernel``,
    which copies the row by its lanes and needs only ``9 * tile_size``
    bytes beside it)."""
    spec = resolve_spec(spec)
    whole = window * spec.vmem_bytes % 16 == 0
    return ("async" if whole and window_ring_stages(window, tile_size, spec)
            else "sync")


def boundary_smem_bytes(tile_size: int) -> int:
    """Dynamic shared memory of the global-tier block: the tile's u and v
    ids and free flags (``launch_boundary`` in the CUDA source requests
    ``9 * T``)."""
    return 9 * tile_size


def boundary_async_smem_bytes(window: int, tile_size: int,
                              spec: Optional[StateSpec] = None,
                              staged: bool = True) -> int:
    """Dynamic shared memory of the asynchronous global tier
    (``boundary_async_smem`` in the CUDA source): the pair's two state
    rows when ``staged``, then ``RING_STAGES`` stages of
    ``TILES_PER_STAGE`` tiles' pairs and u and v ids. The kernel's static
    arrays (:data:`ASYNC_STATIC_SMEM`) come on top."""
    spec = resolve_spec(spec)
    rows = 2 * window * spec.vmem_bytes if staged else 0
    return rows + RING_STAGES * 8 * TILES_PER_STAGE * (1 + tile_size)


def boundary_instance(window: int, tile_size: int,
                      spec: Optional[StateSpec] = None) -> str:
    """The instance of the asynchronous global tier that the shape takes:
    ``"staged"`` when the pair's two state rows fit in shared memory beside
    the ring and a row is a whole number of 16-byte bulk-copy units,
    ``"device"`` otherwise (``legacy_i32()`` at large windows)."""
    spec = resolve_spec(spec)
    fits = (boundary_async_smem_bytes(window, tile_size, spec, True)
            + ASYNC_STATIC_SMEM <= MAX_SMEM_BYTES)
    return ("staged" if fits and window * spec.vmem_bytes % 16 == 0
            else "device")


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


def _window_args(u_rows, v_rows, state_in, tile_size, spec, vector_rounds):
    """Checks common to the window-tier wrappers; returns ``(num_rows,
    slots, window)``."""
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
    return num_rows, slots, state_in.shape[1]


def _check_profile(profile, fields, device) -> None:
    if profile is not None:
        _require(profile.device == device and profile.dtype == torch.int64
                 and profile.shape == (len(fields),),
                 f"profile must be an int64 tensor of {len(fields)} on the "
                 "ids' device")


def _check_window_ids(u_rows, v_rows, window) -> None:
    ids_ok = _ids_ok(u_rows, v_rows, window, window)
    _require(bool(ids_ok),  # host-sync: ok — ids index device memory
             f"edge ids out of range: ids must lie in [0, {window}), "
             "padding is (-1, -1)")


def _window_outputs(u_rows, state_in, spec):
    states = torch.empty_like(state_in)
    matched = torch.empty(u_rows.shape, dtype=spec.counter_dtype,
                          device=u_rows.device)
    return states, matched, torch.empty_like(matched)


def _launch_window_sync(u_rows, v_rows, state_in, tile_size, vector_rounds,
                        fallback, spec):
    num_rows, slots = u_rows.shape
    window = state_in.shape[1]
    smem = window_tier_smem_bytes(window, tile_size, spec)
    _require(smem <= MAX_SMEM_BYTES,
             f"window tier needs {smem} B of shared memory per block "
             f"(window={window}, {spec.vmem} state, tile {tile_size}); "
             f"a block has {MAX_SMEM_BYTES} B")
    _check_window_ids(u_rows, v_rows, window)
    states, matched, conflicts = _window_outputs(u_rows, state_in, spec)
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


def window_tier(
    u_rows: torch.Tensor,
    v_rows: torch.Tensor,
    state_in: torch.Tensor,
    *,
    tile_size: int,
    vector_rounds: int = 1,
    fallback: bool = True,
    spec: Optional[StateSpec] = None,
    profile: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Window tier: row r's state starts from ``state_in[r]`` and its tiles
    are matched in order.

    u_rows, v_rows: int32[num_rows, tiles_per_row * tile_size] window-local
    ids, (-1, -1) padding. state_in: spec.vmem[num_rows, window].
    Returns ``(states spec.vmem[num_rows, window], matched, conflicts)``,
    matched/conflicts ``spec.counter`` of ``u_rows``'s shape.
    On CUDA tensors it launches ``skipper_window_async_kernel`` with the
    ring :func:`window_ring_stages` picks or, where the shape does not
    take it (:func:`window_instance` ``"sync"``: no stage fits beside the
    row, or the row is not a whole number of 16-byte units),
    ``skipper_window_tier_kernel``. ``profile``, an int64 CUDA tensor of
    ``len(WINDOW_PROFILE_FIELDS)`` elements, receives the stage loop's
    cycle spans on thread 0, added over the rows (see
    :data:`WINDOW_PROFILE_FIELDS`); it costs a few clock reads and
    reductions into device memory a stage and a tile, and needs the
    asynchronous kernel.
    """
    spec = resolve_spec(spec)
    num_rows, slots, window = _window_args(u_rows, v_rows, state_in,
                                           tile_size, spec, vector_rounds)
    if u_rows.device.type == "cpu":
        _require(profile is None, "profile= times the CUDA kernel; the "
                 "plain version on the CPU has no cycle profile")
        from repro_torch.kernels.skipper_match.ref import ref_window_tier

        return ref_window_tier(u_rows, v_rows, state_in, tile_size=tile_size,
                               vector_rounds=vector_rounds,
                               fallback=fallback, spec=spec)
    _require(u_rows.device.type == "cuda", "tensors must be on CPU or CUDA")
    if window_instance(window, tile_size, spec) == "sync":
        _require(profile is None,
                 f"window {window} at {spec.vmem} state and tile "
                 f"{tile_size} takes the first window tier (see "
                 "window_instance), which has no profile=")
        return _launch_window_sync(u_rows, v_rows, state_in, tile_size,
                                   vector_rounds, fallback, spec)
    _check_profile(profile, WINDOW_PROFILE_FIELDS, u_rows.device)
    _check_window_ids(u_rows, v_rows, window)
    states, matched, conflicts = _window_outputs(u_rows, state_in, spec)
    if num_rows == 0 or slots == 0:
        states.copy_(state_in)
        return states, matched, conflicts
    if profile is not None:
        profile.zero_()
    if state_in.data_ptr() % 16:  # the row's bulk copy needs 16-byte units
        state_in = state_in.clone()
    stages = window_ring_stages(window, tile_size, spec)
    smem = window_async_smem_bytes(window, tile_size, spec, stages)
    fn = getattr(_library(),
                 f"skipper_window_async_{spec.vmem}_{spec.counter}")
    stream = torch.cuda.current_stream(u_rows.device).cuda_stream
    err = fn(u_rows.data_ptr(), v_rows.data_ptr(), state_in.data_ptr(),
             states.data_ptr(), matched.data_ptr(), conflicts.data_ptr(),
             num_rows, slots // tile_size, tile_size, window, vector_rounds,
             int(fallback), stages, smem,
             None if profile is None else profile.data_ptr(), stream)
    _check_launch(WINDOW_ASYNC, err)
    _LAUNCHES[WINDOW_ASYNC] += 1
    if profile is not None:  # the rest of the loop, after the kernel
        profile[4] = profile[-1] - profile[:4].sum()
    return states, matched, conflicts


def window_tier_sync(
    u_rows: torch.Tensor,
    v_rows: torch.Tensor,
    state_in: torch.Tensor,
    *,
    tile_size: int,
    vector_rounds: int = 1,
    fallback: bool = True,
    spec: Optional[StateSpec] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`window_tier`'s function through ``skipper_window_tier_kernel``,
    which reads each tile's ids from device memory on the tile's chain.
    CUDA tensors only; on the main path only where the asynchronous tier's
    ring does not fit (:func:`window_instance`)."""
    spec = resolve_spec(spec)
    _window_args(u_rows, v_rows, state_in, tile_size, spec, vector_rounds)
    _require(u_rows.device.type == "cuda",
             "window_tier_sync launches a CUDA kernel: CUDA tensors only")
    return _launch_window_sync(u_rows, v_rows, state_in, tile_size,
                               vector_rounds, fallback, spec)


def _boundary_args(state_rows, blk_u, blk_v, u_tiles, v_tiles, spec,
                   vector_rounds):
    """Checks common to both global-tier wrappers; returns
    ``(num_tiles, tile_size, num_windows, window)``."""
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
    return (num_tiles, tile_size) + tuple(state_rows.shape)


def _check_boundary_ids(blk_u, blk_v, u_tiles, v_tiles, num_windows,
                        window) -> None:
    blocks_ok = ((blk_u >= 0) & (blk_u < num_windows) & (blk_v >= 0)
                 & (blk_v < num_windows)).all()
    ids_ok = _ids_ok(u_tiles, v_tiles, window, 2 * window) & blocks_ok
    _require(bool(ids_ok),  # host-sync: ok — ids index device memory
             f"ids out of range: u must lie in [0, {window}), v in "
             f"[0, {2 * window}), padding is (-1, -1), pair blocks in "
             f"[0, {num_windows})")


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
    instance: Optional[str] = None,
    profile: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global tier: the block-pair grouped tiles in schedule order, against
    ``state_rows`` spec.vmem[num_windows, window], updated **in place**.

    blk_u, blk_v: int32[num_tiles] pair rows; u_tiles, v_tiles:
    int32[num_tiles, T] offset-local ids (u in [0, W), v in [0, 2W)).
    Returns ``(matched, conflicts)``, both spec.counter[num_tiles, T].
    On CUDA tensors it launches ``skipper_boundary_async_kernel``, in the
    instance :func:`boundary_instance` picks for the shape; ``instance``
    (``"staged"`` or ``"device"``) names one instead, and a staged instance
    the shape does not fit raises. A tile wider than
    :data:`BOUNDARY_ASYNC_MAX_THREADS` lanes takes
    ``skipper_boundary_kernel`` (:func:`boundary_tier_sync`), and then
    ``instance`` and ``profile`` must be None. ``profile``, an int64 CUDA
    tensor of
    ``len(PROFILE_FIELDS)`` elements, receives the tile loop's cycle
    spans on thread 0 (see :data:`PROFILE_FIELDS`); it costs a few clock
    reads a tile.
    """
    spec = resolve_spec(spec)
    num_tiles, tile_size, num_windows, window = _boundary_args(
        state_rows, blk_u, blk_v, u_tiles, v_tiles, spec, vector_rounds)
    if instance is not None:
        _require(instance in INSTANCES,
                 f"instance must be one of {INSTANCES}, got {instance!r}")
    if state_rows.device.type == "cpu":
        from repro_torch.kernels.skipper_match.ref import ref_boundary_pass

        return ref_boundary_pass(state_rows, blk_u, blk_v, u_tiles, v_tiles,
                                 vector_rounds=vector_rounds,
                                 fallback=fallback, spec=spec)
    _require(state_rows.device.type == "cuda",
             "tensors must be on CPU or CUDA")
    if tile_size > BOUNDARY_ASYNC_MAX_THREADS:
        _require(instance is None and profile is None,
                 f"the asynchronous global tier takes tiles of at most "
                 f"{BOUNDARY_ASYNC_MAX_THREADS} lanes; tile {tile_size} "
                 "takes skipper_boundary_kernel, which has no instance "
                 "and no profile")
        return boundary_tier_sync(state_rows, blk_u, blk_v, u_tiles,
                                  v_tiles, vector_rounds=vector_rounds,
                                  fallback=fallback, spec=spec)
    fit = boundary_instance(window, tile_size, spec)
    instance = instance or fit
    _require(instance == "device" or fit == "staged",
             f"the staged global tier needs the pair's two state rows "
             f"({2 * window * spec.vmem_bytes} B) beside the ring in shared "
             f"memory and 16-byte rows; window {window} at {spec.vmem} "
             f"state and tile {tile_size} does not fit")
    staged = instance == "staged"
    for t in (blk_u, blk_v, u_tiles, v_tiles) + (
            (state_rows,) if staged else ()):
        _require(t.data_ptr() % 16 == 0,
                 "the global tier's bulk copies need 16-byte aligned ids, "
                 "pairs and (staged) state rows")
    smem = boundary_async_smem_bytes(window, tile_size, spec, staged)
    _require(smem + ASYNC_STATIC_SMEM <= MAX_SMEM_BYTES,
             f"global tier needs {smem} B of shared memory (tile "
             f"{tile_size}); a block has {MAX_SMEM_BYTES} B")
    matched = torch.empty(u_tiles.shape, dtype=spec.counter_dtype,
                          device=u_tiles.device)
    conflicts = torch.empty_like(matched)
    if num_tiles == 0:
        return matched, conflicts
    _check_boundary_ids(blk_u, blk_v, u_tiles, v_tiles, num_windows, window)
    _check_profile(profile, PROFILE_FIELDS, u_tiles.device)
    fn = getattr(_library(),
                 f"skipper_boundary_async_{spec.vmem}_{spec.counter}")
    stream = torch.cuda.current_stream(u_tiles.device).cuda_stream
    err = fn(blk_u.data_ptr(), blk_v.data_ptr(), u_tiles.data_ptr(),
             v_tiles.data_ptr(), state_rows.data_ptr(), matched.data_ptr(),
             conflicts.data_ptr(), num_tiles, tile_size, window,
             vector_rounds, int(fallback), int(staged), smem,
             None if profile is None else profile.data_ptr(), stream)
    _check_launch(BOUNDARY_ASYNC, err)
    _LAUNCHES[BOUNDARY_ASYNC] += 1
    return matched, conflicts


def boundary_tier_sync(
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
    """:func:`boundary_tier`'s function through ``skipper_boundary_kernel``,
    which reads each tile's ids and state cells from device memory on the
    tile's chain. CUDA tensors only; nothing on the main path calls it."""
    spec = resolve_spec(spec)
    num_tiles, tile_size, num_windows, window = _boundary_args(
        state_rows, blk_u, blk_v, u_tiles, v_tiles, spec, vector_rounds)
    _require(state_rows.device.type == "cuda",
             "boundary_tier_sync launches a CUDA kernel: CUDA tensors only")
    matched = torch.empty(u_tiles.shape, dtype=spec.counter_dtype,
                          device=u_tiles.device)
    conflicts = torch.empty_like(matched)
    if num_tiles == 0:
        return matched, conflicts
    _check_boundary_ids(blk_u, blk_v, u_tiles, v_tiles, num_windows, window)
    fn = getattr(_library(), f"skipper_boundary_{spec.vmem}_{spec.counter}")
    stream = torch.cuda.current_stream(u_tiles.device).cuda_stream
    err = fn(blk_u.data_ptr(), blk_v.data_ptr(), u_tiles.data_ptr(),
             v_tiles.data_ptr(), state_rows.data_ptr(), matched.data_ptr(),
             conflicts.data_ptr(), num_tiles, tile_size, window,
             vector_rounds, int(fallback), stream)
    _check_launch(BOUNDARY, err)
    _LAUNCHES[BOUNDARY] += 1
    return matched, conflicts
