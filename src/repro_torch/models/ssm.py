"""Mamba-2 blocks (SSD, state-space duality, arXiv:2405.21060) and the
``ssm`` family's LM (port of ``repro.models.ssm``).

Train and prefill run the chunked SSD: within a chunk an "attention-like"
quadratic term with decay masks, across chunks a recurrence of the chunk
end states. Decode updates an O(1) recurrent state a token. Everything is
written out as the reference writes it, in f32 where it computes in f32:
the causal conv is the sum of ``width`` shifted products (not
``F.conv1d``, which may take TF32 and another order of summation), the
softplus is the exact ``logaddexp(x, 0)`` (``F.softplus`` switches to the
identity above 20), and the loop over chunks returns the state before
each chunk, as ``lax.scan`` does there.

``SSMLM`` keeps each block's parameters in an ``nn.ParameterDict`` under
``init_ssm_layer``'s names, so the reference's stacked ``[L, ...]`` leaf
``i`` is ``blocks.i``'s tensor. Its cache is ``{"conv": [L, B, W-1, C],
"ssm": [L, B, H, P, N] f32, "cur": int}``; ``decode_step`` updates it in
place. ``prefill`` returns the reference's cache: zeroed, with ``cur = S``
(the reference's docstring speaks of a primed state, but its code builds
none), so the first decode step after a prompt starts from zero state.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import dtype_of
from repro_torch.models.transformer import LM, frozen


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """``(d_inner, heads, state size N, conv channels)``."""
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    n = cfg.ssm_state
    return d_inner, heads, n, d_inner + 2 * n


def init_ssm_layer(gen: torch.Generator, cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    """One Mamba-2 block's parameters, drawn from ``gen`` on its device;
    ``A_log``, ``D_skip`` and ``dt_bias`` are f32 in every dtype."""
    dt, dev = dtype_of(cfg), gen.device
    d = cfg.d_model
    d_inner, h, n, conv_ch = ssm_dims(cfg)
    p_total = 2 * d_inner + 2 * n + h
    w = cfg.ssm_conv_width

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "norm": zeros(d),
        "in_proj": L.dense_init(gen, (d, p_total), d, dt),
        "conv_w": L.dense_init(gen, (w, conv_ch), w, dt),
        "conv_b": zeros(conv_ch),
        "A_log": zeros(h, dtype=torch.float32),
        "D_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "dt_bias": zeros(h, dtype=torch.float32),
        "gate_norm": zeros(d_inner),
        "out_proj": L.dense_init(gen, (d_inner, d), d_inner, dt),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    d_inner, _, n, _ = ssm_dims(cfg)
    return (proj[..., :d_inner], proj[..., d_inner:2 * d_inner + 2 * n],
            proj[..., 2 * d_inner + 2 * n:])


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` exactly, as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _silu_f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over ``[B, S, C]`` with kernel ``[W, C]``: the
    sum of ``W`` shifted products, then the bias and SiLU in f32."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i].to(xbc.dtype) for i in range(width))
    return _silu_f32(out + b.to(xbc.dtype), xbc.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked SSD. ``x [B, S, H, P]``, ``dt [B, S, H]`` f32 (after the
    softplus), ``a [H]`` f32 (negative), ``bm``/``cm [B, S, N]``; returns
    ``y [B, S, H, P]`` in x's dtype. ``S`` must be a multiple of the chunk
    (or shorter than it: one chunk of ``S``)."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_scan: sequence {s} is not a multiple of the "
                         f"chunk {q}")
    nc = s // q
    xr = x.reshape(b, nc, q, h, p).float()
    dtr = dt.reshape(b, nc, q, h)
    br = bm.reshape(b, nc, q, n).float()
    cr = cm.reshape(b, nc, q, n).float()

    cum = torch.cumsum(dtr * a, dim=2)                      # [b,nc,q,h], <= 0
    # the intra-chunk quadratic term
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)
    scores = cb[..., None] * decay * dtr[:, :, None, :, :]  # [b,nc,i,j,h]
    scores = torch.where(tri[None, None, :, :, None], scores, 0.0)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xr)

    # the chunk-local end states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # [b,nc,q,h]
    s_loc = torch.einsum("bcjn,bcjh,bcjhp->bchpn", br, dtr * decay_end, xr)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [b,nc,h]

    # the recurrence over chunks: the state before each chunk
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = chunk_decay[:, c, :, None, None] * state + s_loc[:, c]
    s_prevs = torch.stack(prevs, dim=1)                     # [b,nc,h,p,n]
    y_inter = (torch.einsum("bcin,bchpn->bcihp", cr, s_prevs)
               * torch.exp(cum)[..., None])
    return (y_intra + y_inter).reshape(b, s, h, p).to(x.dtype)


def ssm_layer_train(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                    cfg: ModelConfig) -> torch.Tensor:
    """One Mamba-2 block (pre-norm residual) over ``x [B, S, D]``."""
    b, s, _ = x.shape
    d_inner, h, n, _ = ssm_dims(cfg)
    hnorm = L.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xbc, dt_raw = _split_proj(hnorm @ p["in_proj"].to(x.dtype), cfg)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_inner].reshape(b, s, h, cfg.ssm_headdim)
    bm = xbc[..., d_inner:d_inner + n]
    cm = xbc[..., d_inner + n:]
    dt = softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y = ssd_scan(xs, dt, a, bm, cm, cfg.ssm_chunk)
    y = y + xs * p["D_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = L.rms_norm(y * _silu_f32(z, x.dtype), p["gate_norm"], cfg.norm_eps)
    return x + y @ p["out_proj"].to(x.dtype)


def init_ssm_cache(cfg: ModelConfig, batch: int, stacked: Tuple[int, ...],
                   device) -> Dict[str, torch.Tensor]:
    """Zero conv windows (model dtype) and SSM states (f32) for
    ``stacked`` blocks: ``[*stacked, B, W-1, C]`` and
    ``[*stacked, B, H, P, N]``."""
    _, h, n, conv_ch = ssm_dims(cfg)
    return {
        "conv": torch.zeros(tuple(stacked) + (batch, cfg.ssm_conv_width - 1,
                                              conv_ch),
                            dtype=dtype_of(cfg), device=device),
        "ssm": torch.zeros(tuple(stacked) + (batch, h, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=device),
    }


def ssm_layer_decode(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                     conv_state: torch.Tensor, ssm_state: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """One token ``x [B, 1, D]`` through one block. Updates ``conv_state
    [B, W-1, C]`` and ``ssm_state [B, H, P, N]`` in place; returns the
    block's output ``[B, 1, D]``."""
    b = x.shape[0]
    d_inner, h, n, _ = ssm_dims(cfg)
    hnorm = L.rms_norm(x, p["norm"], cfg.norm_eps)
    proj = (hnorm @ p["in_proj"].to(x.dtype))[:, 0]
    z, xbc, dt_raw = _split_proj(proj, cfg)

    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)   # [B, W, C]
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(x.dtype))
    conv_out = _silu_f32(conv_out + p["conv_b"].to(x.dtype), x.dtype)
    conv_state.copy_(window[:, 1:])

    xs = conv_out[..., :d_inner].reshape(b, h, cfg.ssm_headdim).float()
    bm = conv_out[..., d_inner:d_inner + n].float()
    cm = conv_out[..., d_inner + n:].float()
    dt = softplus(dt_raw.float() + p["dt_bias"])                # [B, H]
    da = torch.exp(dt * -torch.exp(p["A_log"]))
    new_state = da[:, :, None, None] * ssm_state + torch.einsum(
        "bn,bh,bhp->bhpn", bm, dt, xs)
    ssm_state.copy_(new_state)
    y = (torch.einsum("bhpn,bn->bhp", new_state, cm)
         + xs * p["D_skip"][None, :, None])
    y = y.reshape(b, d_inner).to(x.dtype)
    y = L.rms_norm(y * _silu_f32(z, x.dtype), p["gate_norm"], cfg.norm_eps)
    return x + (y @ p["out_proj"].to(x.dtype))[:, None, :]


def ssm_block(gen: torch.Generator, cfg: ModelConfig) -> nn.ParameterDict:
    """A block's parameters as a frozen ``nn.ParameterDict``."""
    return frozen(init_ssm_layer(gen, cfg))


class SSMLM(LM):
    """The ``ssm`` family's LM (mamba2): embedding, Mamba-2 blocks, final
    norm and head (the embedding, transposed, when tied).

    Weights are drawn from ``gen`` on its device and created frozen, as
    serving wants them (the train step turns their gradients on). With
    ``cfg.remat`` and grad enabled, ``forward`` runs each block under
    ``torch.utils.checkpoint``."""

    #: stacked dims of each top-level key in the reference's pytree
    STACK_DEPTH = {"blocks": 1}

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dt, d = dtype_of(cfg), cfg.d_model
        self.embed = frozen(L.dense_init(gen, (cfg.vocab_size, d), d, dt))
        self.blocks = nn.ModuleList(ssm_block(gen, cfg)
                                    for _ in range(cfg.num_layers))
        self.final_norm = frozen(torch.zeros((d,), dtype=dt,
                                             device=gen.device))
        if not cfg.tie_embeddings:
            self.lm_head = frozen(L.dense_init(gen, (d, cfg.vocab_size), d,
                                               dt))

    def _head(self):
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def _embed(self, tokens):
        return self.embed.to(dtype_of(self.cfg))[tokens.long()]

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False):
        """tokens ``[B, S]`` -> logits ``[B, S, V]``, or ``(hidden, head)``
        after the final norm with ``return_hidden`` (``head`` ``[D, V]``)."""
        x = L.batch_shard(self._embed(tokens))
        remat = self.cfg.remat and torch.is_grad_enabled()
        for bp in self.blocks:
            if remat:
                x = checkpoint(ssm_layer_train, x, bp, self.cfg,
                               use_reentrant=False)
            else:
                x = ssm_layer_train(x, bp, self.cfg)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if return_hidden:
            return x, self._head()
        return L.lm_head(x, self._head())

    def init_cache(self, batch: int, max_len: int) -> Dict[str, object]:
        """An empty cache; O(1) state, so ``max_len`` is unused."""
        del max_len
        cache: Dict[str, object] = dict(init_ssm_cache(
            self.cfg, batch, (self.cfg.num_layers,), self.device))
        cache["cur"] = 0
        return cache

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """The forward's logits and the reference's prefill cache: zeroed,
        ``cur = S``."""
        logits = self(tokens)
        b, s = tokens.shape
        cache = self.init_cache(b, max_len or s)
        cache["cur"] = s
        return logits, cache

    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One token ``[B, 1]`` against the cache (updated in place).
        Returns ``(logits [B, 1, V], cache)`` with ``cur`` advanced."""
        x = self._embed(tokens)
        for i, bp in enumerate(self.blocks):
            x = ssm_layer_decode(x, bp, cache["conv"][i], cache["ssm"][i],
                                 self.cfg)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        cache["cur"] = int(cache["cur"]) + 1
        return L.lm_head(x, self._head()), cache

