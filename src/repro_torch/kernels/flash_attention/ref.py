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
  card's comparisons hold the CUDA kernels against it.
* :func:`split_tf32` — ``x = hi + lo`` with ``hi`` and ``lo`` rounded to
  TF32 as ``cvt.rna.tf32.f32`` rounds, bit for bit; :func:`tf32_planes` —
  the planes the three-term kernel's pre-pass writes from q, k and v.

Layout is the reference's: q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]``; query
head ``h`` reads kv head ``h // (Hq // Hkv)``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
#: the f32 bits a TF32 value leaves zero, and half of their unit
TF32_DROPPED_BITS = 13


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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to the
    nearest value with 10 stored mantissa bits, ties away from zero (add
    half a unit to the magnitude's bits, clear the 13 low ones)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    half = 1 << (TF32_DROPPED_BITS - 1)
    low = (1 << TF32_DROPPED_BITS) - 1
    out = ((bits + half) & ~low) & 0xFFFFFFFF
    out = torch.where(out >= 1 << 31, out - (1 << 32), out)
    return out.to(torch.int32).view(torch.float32).reshape(x.shape)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``: ``hi = tf32(x)``, ``lo = tf32(x - hi)`` (f32 ``x``;
    the subtraction is exact). ``hi + lo`` is within ``2^-22 |x|`` of
    ``x``."""
    x = x.float()
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def padded_dim(d: int) -> int:
    """The head dim padded to whole 32-float (128-byte) columns."""
    return -(-d // 32) * 32


def vt_key_order(s: int) -> torch.Tensor:
    """Stored position -> key of a V^T row of ``s`` keys (``s`` a multiple
    of 8): each group of 8 holds keys 0 2 4 6 1 3 5 7, the order in which a
    TF32 wgmma A fragment meets the accumulator's keys."""
    p = torch.arange(s)
    return (p & ~7) + 2 * (p & 3) + ((p >> 2) & 1)


def tf32_planes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                sm_scale: float) -> dict:
    """What the three-term kernel's pre-pass writes: ``q_hi``, ``q_lo``
    (``f32(q) * sm_scale`` split) and ``k_hi``, ``k_lo`` as ``[B*H, S,
    Dp]`` rows zero-padded to :func:`padded_dim`; ``v_hi``, ``v_lo`` as
    ``[B*Hkv, D, S]``, transposed, keys in :func:`vt_key_order`. For bf16
    inputs ``k_lo`` and ``v_lo`` are None (zero: bf16 is exact in TF32)."""
    b, hq, s, d = q.shape
    hkv, dp = k.shape[1], padded_dim(d)

    def rows(x, heads):
        out = torch.zeros((b * heads, s, dp), dtype=torch.float32,
                          device=x.device)
        out[..., :d] = x.reshape(b * heads, s, d)
        return out

    planes = {}
    planes["q_hi"], planes["q_lo"] = (rows(t, hq) for t in split_tf32(
        q.float() * sm_scale))
    k_hi, k_lo = split_tf32(k)
    vt = v.float().reshape(b * hkv, s, d)[:, vt_key_order(s).to(v.device)]
    v_hi, v_lo = (t.transpose(1, 2).contiguous() for t in split_tf32(vt))
    planes["k_hi"], planes["v_hi"] = rows(k_hi, hkv), v_hi
    lo = q.dtype == torch.float32
    planes["k_lo"] = rows(k_lo, hkv) if lo else None
    planes["v_lo"] = v_lo if lo else None
    return planes
