"""Entry point of the flash attention kernel (port of
``repro.kernels.flash_attention.ops``).

``flash_attention(q, k, v, ...)`` takes the reference's layout, q
``[B, Hq, S, D]`` and k/v ``[B, Hkv, S, D]``, and returns ``[B, Hq, S, D]``
in q's dtype. It runs on the card unless the caller asks for the CPU
(``device="cpu"``), as the port's other entry points do. On the card it
launches a hand-written kernel (``kernel.flash_attention_cuda``: the bf16
tensor-core kernel for bf16 at head dim 64 or 128, the three-term TF32
kernel after its pre-pass otherwise) or raises; on the CPU it runs the
plain online-softmax version (``ref.online_softmax_attention``). Nothing
falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    device=None,
) -> torch.Tensor:
    """Causal (or full) GQA attention with an optional sliding window.

    ``device`` is where it runs: ``None`` means ``"cuda"`` and raises
    ``RuntimeError`` without a card; q, k and v are moved there first. Blocks are ``min(block, S)``, as in
    the reference. Raises ``ValueError`` for a head dim outside
    ``{64, 80, 128}``, a sequence length that the blocks do not divide, or
    query heads that the kv heads do not divide."""
    device = resolve_device(device, "cuda", "flash_attention")
    q, k, v = (t.to(device) for t in (q, k, v))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, Hq, S, D] and k, v one [B, Hkv, S, D]")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in kernel.HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {kernel.HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv "
                         "heads")
    bq, bk = min(block_q, s), min(block_k, s)
    if bq <= 0 or bk <= 0 or s % bq or s % bk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"blocks ({bq}, {bk})")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if device.type == "cpu":
        return ref.online_softmax_attention(
            q, k, v, block_q=bq, block_k=bk, causal=causal, window=window,
            sm_scale=sm_scale)
    return kernel.flash_attention_cuda(
        q, k, v, causal=causal, window=window, sm_scale=sm_scale,
        block_q=bq, block_k=bk)
