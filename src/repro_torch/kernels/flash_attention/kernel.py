"""Build, load and launch the hand-written flash attention CUDA kernel.

``csrc/flash_attention.cu`` holds the kernel with a plain C interface; it is
built and loaded through ``kernels/_build.py`` (nvcc for ``sm_90a`` into
``build/repro_torch/``, ``ctypes``).

:func:`flash_attention_cuda` launches ``flash_attention_kernel`` on the
current stream for CUDA tensors. It checks device, dtype, shape, contiguity,
the block geometry and the shared-memory size, raises on a launch error,
and adds one to the launch count each time it launches the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import MAX_SMEM_BYTES

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

HEAD_DIMS = (64, 80, 128)
#: lanes that share one query row (``kLanesPerRow`` in the source)
LANES_PER_ROW = 4
MAX_BLOCK_Q = 128

FLASH = "flash_attention_kernel"

_LAUNCHES: Dict[str, int] = {FLASH: 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int


def launch_counts() -> Dict[str, int]:
    """Launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES[FLASH] = 0


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int, sm_scale: float,
                         block_q: int, block_k: int) -> torch.Tensor:
    """Launch the kernel: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]``, all
    contiguous CUDA tensors of one dtype (f32 or bf16). Returns a new
    ``[B, Hq, S, D]`` tensor of q's dtype. The shape checks common to both
    paths are ``ops.flash_attention``'s."""
    for t in (q, k, v):
        _require(t.device.type == "cuda" and t.device == q.device,
                 "q, k and v must lie on one CUDA device")
        _require(t.is_contiguous(), "q, k and v must be contiguous")
        _require(t.dtype == q.dtype, "q, k and v must share one dtype")
    _require(q.dtype in (torch.float32, torch.bfloat16),
             f"the kernel takes float32 or bfloat16, got {q.dtype}")
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
