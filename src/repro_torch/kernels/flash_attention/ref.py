"""Plain PyTorch versions of the flash attention kernel (port of
``repro.kernels.flash_attention.ref``).

* :func:`ref_attention` — the oracle: repeat k/v over the query group, mask,
  softmax, all in f32 (``ref.ref_attention``). Returns f32, as the
  reference does.
* :func:`online_softmax_attention` — the kernel's own arithmetic, step by
  step (``kernel.py::flash_attention_kernel``): per ``block_q`` query block,
  the kv loop over ``block_k`` chunks trimmed to ``[lo, hi)``, masking with
  the ``-1e30`` sentinel (not ``-inf``: a chunk that is wholly masked at the
  start of a row gives ``p = exp(0) = 1`` until a real score wipes it
  through ``alpha``), the online-softmax recurrence in f32, and the division
  by ``l_safe``. The CPU path of ``ops.flash_attention`` runs it, and the
  card's comparisons hold the CUDA kernel against it.

Layout is the reference's: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]``; query
head ``h`` reads kv head ``h // (Hq // Hkv)``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: int = 0,
                  sm_scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked softmax attention in f32; returns f32 ``[B, Hq, S, D]``."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    kv_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv)


def kv_range(qi: int, block_q: int, block_k: int, seq_len: int, causal: bool,
             window: int) -> range:
    """The kv chunks query block ``qi`` visits (``kernel.py:48``–``:83``):
    ``hi`` is trimmed to the causal frontier whenever ``causal`` is set,
    ``lo`` to the window only when both ``causal`` and ``window`` are."""
    num_kv = seq_len // block_k
    hi = (min(((qi + 1) * block_q + block_k - 1) // block_k, num_kv)
          if causal else num_kv)
    lo = (max(qi * block_q - window + 1, 0) // block_k
          if causal and window > 0 else 0)
    return range(lo, hi)


def online_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, block_q: int, block_k: int,
                             causal: bool = True, window: int = 0,
                             sm_scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's chunk loop in plain PyTorch; returns ``q.dtype``
    ``[B, Hq, S, D]``. ``block_q`` and ``block_k`` must divide ``S``."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    out = torch.empty_like(q)
    iq = torch.arange(block_q, device=q.device)[:, None]
    ik = torch.arange(block_k, device=q.device)[None, :]
    for qi in range(s // block_q):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        qb = q[:, :, rows].float() * sm_scale
        q_pos = qi * block_q + iq
        m_i = torch.full((b, hq, block_q), NEG_INF, device=q.device)
        l_i = torch.zeros((b, hq, block_q), device=q.device)
        acc = torch.zeros((b, hq, block_q, d), device=q.device)
        for j in kv_range(qi, block_q, block_k, s, causal, window):
            cols = slice(j * block_k, (j + 1) * block_k)
            scores = torch.einsum("bhqd,bhkd->bhqk", qb, kk[:, :, cols])
            kv_pos = j * block_k + ik
            mask = torch.ones((block_q, block_k), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kv_pos <= q_pos
            if window > 0:
                mask &= kv_pos > q_pos - window
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m_i, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m_i - m_new)
            l_i = l_i * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vv[:, :, cols])
            m_i = m_new
        l_safe = torch.where(l_i > 0, l_i, 1.0)
        out[:, :, rows] = (acc / l_safe[..., None]).to(q.dtype)
    return out
