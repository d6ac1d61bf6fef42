"""Build, load and launch the hand-written flash attention CUDA kernels.

Three sources, each with a plain C interface, built and loaded through
``kernels/_build.py`` (nvcc for ``sm_90a`` into ``build/repro_torch/``,
``ctypes``):

* ``csrc/flash_attention_wgmma.cu`` — ``flash_attention_wgmma_kernel``:
  bf16 with head dim 64 or 128, on the tensor cores (wgmma), fed by TMA.
* ``csrc/flash_attention_tf32.cu`` — ``flash_attention_tf32x3_kernel``:
  f32 at head dim 64, 80 and 128 and bf16 at head dim 80, on the TF32
  tensor cores in three terms (``a_hi b_hi + a_hi b_lo + a_lo b_hi``),
  after its pre-pass ``flash_split_tf32_kernel`` splits Q * scale, K and V
  into TF32 hi and lo planes (rows padded to :func:`ref.padded_dim`, V
  transposed).
* ``csrc/flash_attention.cu`` — ``flash_attention_kernel``: f32 FMA on the
  CUDA cores, the first kernel; no entry point reaches it, and
  :func:`flash_attention_cuda_cores` keeps it callable as the yardstick.

:func:`flash_attention_cuda` picks one by dtype and head dim
(:func:`kernel_for`) and launches it on the current stream for CUDA
tensors. It checks device, dtype, shape, contiguity, the block geometry and
the shared-memory size, raises on a launch error, and adds one to the
launched kernel's count (the pre-pass has a count of its own).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
WGMMA_SOURCE = SOURCE.with_name("flash_attention_wgmma.cu")
TF32_SOURCE = SOURCE.with_name("flash_attention_tf32.cu")

HEAD_DIMS = (64, 80, 128)
#: lanes that share one query row (``kLanesPerRow`` in the source)
LANES_PER_ROW = 4
MAX_BLOCK_Q = 128

FLASH = "flash_attention_kernel"
FLASH_WGMMA = "flash_attention_wgmma_kernel"
FLASH_TF32 = "flash_attention_tf32x3_kernel"
FLASH_SPLIT = "flash_split_tf32_kernel"
#: head dims of the tensor-core kernel (bf16 only)
WGMMA_HEAD_DIMS = (64, 128)
#: query rows of one tensor-core block (two consumer warpgroups), keys of
#: one K/V chunk, and the chunks in its ring (``Geometry``, ``kStages``)
WGMMA_BLOCK_Q = 128
WGMMA_BLOCK_K = 64
WGMMA_STAGES = 3
#: bf16 terms the tensor-core kernel splits P into before the PV product
#: (about 8 bits each): one or two leave the output more than one bf16
#: step from the plain version where a row's terms cancel
P_TERMS = 3

#: the tensor-core kernel's setmaxnreg shares (``kProducerRegs``,
#: ``kConsumerRegs``)
WGMMA_PRODUCER_REGS = 40
WGMMA_CONSUMER_REGS = 232
#: the three-term kernel's geometry by head dim (``Geometry<D>`` in its
#: source): consumer warpgroups of 64 query rows, keys a chunk, chunks in
#: its ring, and the producer's and consumers' setmaxnreg shares (0: none)
TF32_GEOMETRY = {64: (2, 64, 2, 40, 232), 80: (2, 32, 2, 40, 232),
                 128: (1, 32, 2, 0, 0)}
#: the (head dim, dtype) instances of the three-term kernel and its
#: pre-pass (bf16 at 64 and 128 runs on the bf16 tensor-core kernel)
TF32_INSTANCES = ((64, "float32"), (80, "float32"), (128, "float32"),
                  (80, "bfloat16"))
#: threads of one pre-pass block
SPLIT_THREADS = 256

_LAUNCHES: Dict[str, int] = {FLASH: 0, FLASH_WGMMA: 0, FLASH_TF32: 0,
                             FLASH_SPLIT: 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> Dict[str, int]:
    """Launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs ``dtype`` at ``head_dim``: the bf16
    tensor-core kernel for bf16 at head dim 64 or 128, the three-term TF32
    kernel otherwise (f32 at every head dim, bf16 at 80)."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return FLASH_WGMMA
    return FLASH_TF32


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("float32", "bfloat16"):
        fn = getattr(lib, f"flash_attention_{name}")
        fn.argtypes = ([_VP] * 4 + [_I] * 7 + [ctypes.c_float] + [_I] * 3
                       + [_VP])
        fn.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return _build.load(SOURCE, _declare)


def _declare_wgmma(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_wgmma_bfloat16
    fn.argtypes = [_VP] * 4 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_VP]
    fn.restype = _I
    lib.flash_attention_wgmma_smem_bytes.argtypes = [_I]
    lib.flash_attention_wgmma_smem_bytes.restype = _I
    lib.flash_attention_wgmma_error_string.argtypes = [_I]
    lib.flash_attention_wgmma_error_string.restype = ctypes.c_char_p


def _wgmma_library() -> ctypes.CDLL:
    return _build.load(WGMMA_SOURCE, _declare_wgmma)


def wgmma_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one tensor-core block (the ``Geometry``
    of the CUDA source): the 128-row Q tile, ``WGMMA_STAGES`` stages of a
    K and a V chunk of ``WGMMA_BLOCK_K`` rows, the mbarriers (one for Q,
    a full and an empty one a stage), and 1024 bytes to align the swizzle
    atoms."""
    return (2 * head_dim * (WGMMA_BLOCK_Q + WGMMA_STAGES * 2 * WGMMA_BLOCK_K)
            + 8 * (1 + 2 * WGMMA_STAGES) + 1024)


def _declare_tf32(lib: ctypes.CDLL) -> None:
    lib.flash_attention_tf32_split.argtypes = ([_VP] * 9 + [_I] * 6
                                               + [ctypes.c_float, _VP])
    lib.flash_attention_tf32_split.restype = _I
    lib.flash_attention_tf32x3.argtypes = [_VP] * 7 + [_I] * 8 + [_VP]
    lib.flash_attention_tf32x3.restype = _I
    lib.flash_attention_tf32_smem_bytes.argtypes = [_I]
    lib.flash_attention_tf32_smem_bytes.restype = _I
    lib.flash_attention_tf32_error_string.argtypes = [_I]
    lib.flash_attention_tf32_error_string.restype = ctypes.c_char_p


def _tf32_library() -> ctypes.CDLL:
    return _build.load(TF32_SOURCE, _declare_tf32)


def tf32_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one three-term block (``Layout`` in its
    source): the Q_hi and Q_lo planes of ``64 * consumers`` rows, then
    ``stages`` stages of the K_hi, K_lo (``BK`` rows of ``Dp`` floats) and
    V^T_hi, V^T_lo (``D`` rows of ``BK`` floats) planes, the mbarriers (one
    for Q, a full and an empty one a stage) and 1024 bytes to align the
    swizzle atoms."""
    consumers, bk, stages = TF32_GEOMETRY[head_dim][:3]
    dp = ref.padded_dim(head_dim)
    q_plane = 4 * dp * 64 * consumers
    stage = 4 * 2 * bk * (dp + head_dim)
    return 2 * q_plane + stages * stage + 8 * (1 + 2 * stages) + 1024


def tf32_setmaxnreg(head_dim: int):
    """``(registers, warpgroups)`` the three-term kernel's warpgroups set
    with setmaxnreg at ``head_dim`` (empty where it sets none)."""
    consumers, _, _, producer, consumer = TF32_GEOMETRY[head_dim]
    return ((producer, 1), (consumer, consumers)) if producer else ()


def smem_bytes(head_dim: int, block_q: int, block_k: int) -> int:
    """Dynamic shared memory of one block: a k chunk and a v chunk in f32,
    each row split into four quarters of ``D / 4`` floats plus one pad
    float, then the ``block_q x (block_k + 1)`` f32 scores (the layout in
    the CUDA source)."""
    row = LANES_PER_ROW * (head_dim // LANES_PER_ROW + 1)
    return 4 * (2 * block_k * row + block_q * (block_k + 1))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for t in (q, k, v):
        _require(t.device.type == "cuda" and t.device == q.device,
                 "q, k and v must lie on one CUDA device")
        _require(t.is_contiguous(), "q, k and v must be contiguous")
        _require(t.dtype == q.dtype, "q, k and v must share one dtype")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"the kernel takes float32 or bfloat16, got {q.dtype}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, sm_scale: float,
                         block_q: int, block_k: int) -> torch.Tensor:
    """Launch the kernel :func:`kernel_for` names: q ``[B, Hq, S, D]``,
    k/v ``[B, Hkv, S, D]``, all contiguous CUDA tensors of one dtype (f32
    or bf16). Returns a new ``[B, Hq, S, D]`` tensor of q's dtype. The
    shape checks common to both paths are ``ops.flash_attention``'s. The
    tensor-core kernel tiles the sequence its own way; ``block_q`` and
    ``block_k`` do not change the function (see its source note)."""
    _check(q, k, v)
    if kernel_for(q.dtype, q.shape[-1]) == FLASH_WGMMA:
        return _launch_wgmma(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    return _launch_tf32(q, k, v, causal=causal, window=window,
                        sm_scale=sm_scale)


def split_tf32_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> Dict[str, torch.Tensor]:
    """The three-term kernel's pre-pass, ``flash_split_tf32_kernel``: the
    planes :func:`ref.tf32_planes` describes, as new CUDA tensors (for
    bf16 input ``k_lo`` and ``v_lo`` are None). f32 at head dim 64, 80 or
    128, bf16 at 80; the sequence a multiple of 8."""
    _check(q, k, v)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    _require((d, str(q.dtype)[6:]) in TF32_INSTANCES,
             f"the three-term kernel takes f32 at head dim 64, 80 or 128 "
             f"and bf16 at 80, got {q.dtype} at {d}")
    _require(s % 8 == 0, f"the three-term kernel needs the sequence a "
             f"multiple of 8 (V^T keys in groups of 8), got {s}")
    dp = ref.padded_dim(d)
    lo = q.dtype == torch.float32
    f32 = dict(dtype=torch.float32, device=q.device)
    planes = {
        "q_hi": torch.empty((b * hq, s, dp), **f32),
        "q_lo": torch.empty((b * hq, s, dp), **f32),
        "k_hi": torch.empty((b * hkv, s, dp), **f32),
        "k_lo": torch.empty((b * hkv, s, dp), **f32) if lo else None,
        "v_hi": torch.empty((b * hkv, d, s), **f32),
        "v_lo": torch.empty((b * hkv, d, s), **f32) if lo else None,
    }
    if q.numel() == 0:
        return planes
    lib = _tf32_library()
    ptr = {n: (0 if x is None else x.data_ptr()) for n, x in planes.items()}
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_tf32_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr["q_hi"], ptr["q_lo"],
        ptr["k_hi"], ptr["k_lo"], ptr["v_hi"], ptr["v_lo"], int(not lo), b,
        hq, hkv, s, d, float(sm_scale), stream)
    if err != 0:
        msg = lib.flash_attention_tf32_error_string(err).decode()
        raise RuntimeError(f"{FLASH_SPLIT} launch failed: CUDA error {err} "
                           f"({msg})")
    _LAUNCHES[FLASH_SPLIT] += 1
    return planes


def _launch_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int, sm_scale: float) -> torch.Tensor:
    planes = split_tf32_cuda(q, k, v, sm_scale)
    return tf32x3_on_planes(planes, torch.empty_like(q), k.shape[1],
                            causal=causal, window=window)


def tf32x3_on_planes(planes: Dict[str, torch.Tensor], out: torch.Tensor,
                     hkv: int, *, causal: bool, window: int) -> torch.Tensor:
    """``flash_attention_tf32x3_kernel`` on the pre-pass's ``planes``
    (:func:`split_tf32_cuda`), into ``out`` ``[B, Hq, S, D]`` of the input
    dtype; returns ``out``. The entry point runs it right after the
    pre-pass; alone it times the main kernel without the pre-pass."""
    b, hq, s, d = out.shape
    _require(out.is_contiguous() and (d, str(out.dtype)[6:]) in
             TF32_INSTANCES, f"the three-term kernel writes a contiguous "
             f"f32 output at head dim 64, 80 or 128 or bf16 at 80, got "
             f"{out.dtype} at {d}")
    dp, lo = ref.padded_dim(d), out.dtype == torch.float32
    rows, cols = (s, dp), (d, s)
    for name, heads, shape, needed in (
            ("q_hi", hq, rows, True), ("q_lo", hq, rows, True),
            ("k_hi", hkv, rows, True), ("k_lo", hkv, rows, lo),
            ("v_hi", hkv, cols, True), ("v_lo", hkv, cols, lo)):
        x = planes[name]
        _require(x is not None or not needed, f"plane {name} is missing")
        _require(x is None or (
            x.shape == (b * heads,) + shape and x.dtype == torch.float32
            and x.is_contiguous() and x.device == out.device),
            f"plane {name} is not a contiguous f32 {(b * heads,) + shape} "
            "tensor on the output's device")
    smem = tf32_smem_bytes(d)
    _require(smem <= MAX_SMEM_BYTES,
             f"{FLASH_TF32} needs {smem} B of shared memory per block "
             f"(D={d}); a block has {MAX_SMEM_BYTES} B")
    if out.numel() == 0:
        return out
    lib = _tf32_library()
    _require(lib.flash_attention_tf32_smem_bytes(d) == smem,
             "the wrapper's shared-memory size disagrees with the source's")
    ptr = {n: (0 if x is None else x.data_ptr()) for n, x in planes.items()}
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.flash_attention_tf32x3(
        ptr["q_hi"], ptr["q_lo"], ptr["k_hi"], ptr["k_lo"], ptr["v_hi"],
        ptr["v_lo"], out.data_ptr(), int(out.dtype != torch.float32), b, hq,
        hkv, s, d, int(causal), int(window), stream)
    if err != 0:
        msg = lib.flash_attention_tf32_error_string(err).decode()
        raise RuntimeError(f"{FLASH_TF32} launch failed: CUDA error {err} "
                           f"({msg})")
    _LAUNCHES[FLASH_TF32] += 1
    return out


def flash_attention_cuda_cores(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool, window: int,
                               sm_scale: float, block_q: int,
                               block_k: int) -> torch.Tensor:
    """``flash_attention_kernel`` whatever the dtype: the first kernel,
    which no entry point reaches any more; kept callable as the yardstick
    of the kernels that replaced it."""
    _check(q, k, v)
    b, hq, s, d = q.shape
    _require(block_q % 8 == 0 and block_q <= MAX_BLOCK_Q,
             f"the kernel needs block_q a multiple of 8 and at most "
             f"{MAX_BLOCK_Q} (four lanes a row, whole warps); got {block_q}")
    smem = smem_bytes(d, block_q, block_k)
    _require(smem <= MAX_SMEM_BYTES,
             f"flash attention needs {smem} B of shared memory per block "
             f"(D={d}, block_q={block_q}, block_k={block_k}); a block has "
             f"{MAX_SMEM_BYTES} B")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = getattr(_library(), f"flash_attention_{str(q.dtype)[6:]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
             k.shape[1], s, d, block_q, block_k, float(sm_scale), int(causal),
             int(window), smem, stream)
    if err != 0:
        msg = _library().flash_attention_error_string(err).decode()
        raise RuntimeError(f"{FLASH} launch failed: CUDA error {err} ({msg})")
    _LAUNCHES[FLASH] += 1
    return out


def flash_attention_wgmma_p_terms(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool,
                                  window: int, sm_scale: float,
                                  p_terms: int) -> torch.Tensor:
    """The tensor-core kernel with P split into ``p_terms`` bf16 terms
    (1 to 3; the entry point uses :data:`P_TERMS`): the measurement of why
    the kernel splits P. bf16 CUDA tensors at head dim 64 or 128; nothing
    on a path calls it."""
    _check(q, k, v)
    _require(kernel_for(q.dtype, q.shape[-1]) == FLASH_WGMMA,
             "the tensor-core kernel takes bf16 at head dim 64 or 128")
    _require(1 <= p_terms <= 3, f"p_terms must be 1, 2 or 3, got {p_terms}")
    return _launch_wgmma(q, k, v, causal=causal, window=window,
                         sm_scale=sm_scale, p_terms=p_terms)


def _launch_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int, sm_scale: float,
                  p_terms: int = P_TERMS) -> torch.Tensor:
    b, hq, s, d = q.shape
    for t in (q, k, v):
        _require(t.data_ptr() % 16 == 0,
                 "the tensor-core kernel's TMA loads need 16-byte aligned "
                 "q, k and v")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _wgmma_library()
    _require(lib.flash_attention_wgmma_smem_bytes(d) == wgmma_smem_bytes(d),
             "the wrapper's shared-memory size disagrees with the source's")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_wgmma_bfloat16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        k.shape[1], s, d, float(sm_scale), int(causal), int(window),
        int(p_terms), stream)
    if err != 0:
        msg = lib.flash_attention_wgmma_error_string(err).decode()
        raise RuntimeError(f"{FLASH_WGMMA} launch failed: CUDA error {err} "
                           f"({msg})")
    _LAUNCHES[FLASH_WGMMA] += 1
    return out
