"""Shared neural layers (port of ``repro.models.layers``): norms, RoPE, GQA
attention (prefill: the chunked online-softmax "flash in plain PyTorch";
decode: over a cache, optionally a rolling window), gated MLPs, init and
the LM head.

Plain functions on tensors, with the reference's layouts (activations
``[B, S, ...]``, weights ``[in, out]``). Norms and softmax accumulate in
f32. Where the reference asks XLA for an f32 product of bf16 operands
(``preferred_element_type=f32``), the port casts the operands to f32
first: the products of bf16 values are exact in f32, so the two compute
the same sums. The reference's sharding hints (``batch_shard``,
``seq_shard`` and ``lm_head``'s constraint) call
``parallel.sharding.constrain`` where it does; they change no number.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import Spec, constrain

NEG_INF = -1e30


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [...] -> cos/sin [..., head_dim // 2] (f32)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE: positions ``[3, B, S]`` (t, h, w) ->
    cos/sin ``[B, S, head_dim // 2]`` (f32). The frequency slots are split
    into (t, h, w) sections, each driven by its own position stream."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim // 2 = {half}")
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    # the section id of each frequency slot
    sec_id = torch.from_numpy(np.repeat(np.arange(len(sections)), sections))
    pos_per_freq = positions.float()[sec_id.to(positions.device)]
    ang = pos_per_freq.movedim(0, -1) * freqs       # [B, S, half]
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, hd]; cos/sin [B, S, hd // 2] -> rotated x (same dtype)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def gqa_attention_chunked(
    q: torch.Tensor,   # [B, S, Hq, hd]
    k: torch.Tensor,   # [B, S, Hkv, hd]
    v: torch.Tensor,   # [B, S, Hkv, hd]
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 2048,
    kv_chunk: int = 1024,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax chunked attention with bounded memory at any S. The
    plain analogue of the flash kernel: unlike the kernel it visits every
    kv chunk (masking, not trimming). Falls back to one unchunked pass along
    an axis whose length the chunk does not divide. Returns
    ``[B, S, Hq, hd]`` in q's dtype."""
    b, s, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qc = min(q_chunk, s)
    if s % qc:
        qc = s
    kc = min(kv_chunk, sk)
    if sk % kc:
        kc = sk
    if (causal or window) and s != sk:
        raise ValueError("causal/window attention requires equal q/kv lengths")

    qr = q.reshape(b, s // qc, qc, hkv, g, hd)
    kr = k.reshape(b, sk // kc, kc, hkv, hd)
    vr = v.reshape(b, sk // kc, kc, hkv, hd)
    dev = q.device
    outs = []
    for qi in range(s // qc):
        # the reference scales q in its own dtype
        qs = (qr[:, qi] * torch.tensor(scale, dtype=q.dtype)).float()
        q_pos = qi * qc + torch.arange(qc, device=dev)
        m_i = torch.full((b, hkv, g, qc), NEG_INF, device=dev)
        l_i = torch.zeros((b, hkv, g, qc), device=dev)
        acc = torch.zeros((b, hkv, g, qc, hd), device=dev)
        for ki in range(sk // kc):
            kblk, vblk = kr[:, ki], vr[:, ki]
            scores = torch.einsum("bqkgd,btkd->bkgqt", qs, kblk.float())
            kv_pos = ki * kc + torch.arange(kc, device=dev)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= kv_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= kv_pos[None, :] > q_pos[:, None] - window
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m_i, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            alpha = torch.exp(m_i - m_new)
            l_i = l_i * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(vblk.dtype).float(), vblk.float())
            m_i = m_new
        l_safe = torch.where(l_i > 0, l_i, 1.0)
        outs.append((acc / l_safe[..., None]).to(q.dtype))  # [B,Hkv,G,qc,hd]
    out = torch.stack(outs, dim=3)                # [B,Hkv,G,nq,qc,hd]
    out = out.reshape(b, hkv, g, s, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, hq, hd)


def gqa_attention_decode(
    q: torch.Tensor,          # [B, 1, Hq, hd]
    k_cache: torch.Tensor,    # [B, W, Hkv, hd]
    v_cache: torch.Tensor,    # [B, W, Hkv, hd]
    cache_pos: torch.Tensor,  # int32[W] position of each slot (-1 empty)
    cur_pos: int,
    *,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a (possibly rolling) KV cache."""
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    qs = q.reshape(b, hkv, g, hd) * torch.tensor(scale, dtype=q.dtype)
    scores = torch.einsum("bkgd,bwkd->bkgw", qs.float(), k_cache.float())
    mask = (cache_pos >= 0) & (cache_pos <= cur_pos)
    if window > 0:
        mask &= cache_pos > cur_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


# ---------------------------------------------------------------- mlps -----
def gated_mlp(x, w_gate, w_up, w_down, act: str = "swiglu",
              b_gate=None, b_up=None, b_down=None):
    h_gate = x @ w_gate.to(x.dtype)
    if b_gate is not None:
        h_gate = h_gate + b_gate.to(x.dtype)
    if act == "swiglu":
        h_up = x @ w_up.to(x.dtype)
        if b_up is not None:
            h_up = h_up + b_up.to(x.dtype)
        h = F.silu(h_gate.float()).to(x.dtype) * h_up
    elif act == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h_gate.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    out = h @ w_down.to(x.dtype)
    if b_down is not None:
        out = out + b_down.to(x.dtype)
    return out


# ------------------------------------------------------------- initutil ----
def dense_init(gen: torch.Generator, shape, in_axis_size: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1 / in_axis_size) drawn in f32 from ``gen`` on its device,
    then cast. One tensor at a time lives in f32."""
    scale = (1.0 / max(in_axis_size, 1)) ** 0.5
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    return (out * scale).to(dtype)


# ---------------------------------------------------------------- head -----
def lm_head(x: torch.Tensor, head_w: torch.Tensor,
            transpose: bool = False) -> torch.Tensor:
    """Final projection to the vocab, in x's dtype: ``head_w`` is
    ``[D, V]``, or ``[V, D]`` with ``transpose``. The ``[B, S, V]``
    logits are laid out with the vocab over ``"model"``, as the
    reference pins them."""
    w = head_w.to(x.dtype)
    return _constrain(x @ (w.T if transpose else w),
                      (FSDP, None, "model"))


#: the data axes of a batch entry in the reference's hints
FSDP = ("pod", "data")


def _constrain(x: torch.Tensor, entries) -> torch.Tensor:
    # The reference's layout hints, kept at its call sites. On every run
    # path of the port they change nothing: activations are each rank's
    # own plain tensors, never DTensors, so ``constrain`` returns them.
    return constrain(x, Spec(*entries))


def batch_shard(x: torch.Tensor) -> torch.Tensor:
    """Lay the leading (batch) dim over the data axes. A no-op without a
    mesh, and for the rank-local tensors of a run."""
    return _constrain(x, (FSDP,) + (None,) * (x.dim() - 1))


def seq_shard(x: torch.Tensor) -> torch.Tensor:
    """Megatron-style sequence parallelism: the ``[B, S, D]`` residual
    with batch over the data axes and sequence over ``"model"``. A no-op
    without a mesh."""
    return _constrain(x, (FSDP, "model", None))
