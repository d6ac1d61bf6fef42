"""Zamba2-style hybrid LM, family ``hybrid`` (arXiv:2411.15242; port of
``repro.models.hybrid``): ``num_layers // shared_attn_period`` groups of
``shared_attn_period`` Mamba-2 blocks, with ONE shared attention block and
gated MLP (a single copy of its parameters) applied after each group.
A KV cache exists only at those application points.

Parameters keep the reference's names and layout: ``ssm_blocks.a.j`` is
leaf ``[a, j]`` of the reference's ``[n_apps, period, ...]`` stack, and
``shared`` is unstacked (``attn.{wq,wk,wv,wo}``, ``mlp.{w_gate,w_up,
w_down}``, ``norm1``, ``norm2``). The cache is ``{"conv": [n_apps, period,
B, W-1, C], "ssm": [n_apps, period, B, H, P, N] f32, "k", "v": [n_apps, B,
max_len, Hkv, hd], "pos": int32[max_len], "cur": int}``; ``decode_step``
updates it in place, writing slot ``cur % max_len``. ``prefill`` returns
the reference's cache: SSM state zeroed, the KV cache empty (``pos`` all
-1), ``cur = S``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.moe import dtype_of
from repro_torch.models.transformer import (
    LM, Block, _attn_decode, _attn_train, frozen,
)


def n_apps(cfg: ModelConfig) -> int:
    """How many times the shared block is applied."""
    return cfg.num_layers // cfg.shared_attn_period


class HybridLM(LM):
    """The ``hybrid`` family's LM (zamba2). Weights are drawn from ``gen``
    on its device, created frozen. With ``cfg.remat`` and grad enabled,
    ``forward`` runs each group under ``torch.utils.checkpoint`` and, inside
    it, each Mamba-2 block under its own, as the reference nests its
    ``jax.checkpoint``s."""

    #: stacked dims of each top-level key in the reference's pytree
    STACK_DEPTH = {"ssm_blocks": 2}

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        apps, period = n_apps(cfg), cfg.shared_attn_period
        if apps * period != cfg.num_layers:
            raise ValueError(f"{cfg.num_layers} layers are not groups of "
                             f"{period}")
        self.cfg = cfg
        dt, d = dtype_of(cfg), cfg.d_model
        # attn.{wq,wk,wv,wo}, mlp.{w_gate,w_up,w_down}, norm1, norm2
        self.shared = Block(cfg, gen)
        self.embed = frozen(L.dense_init(gen, (cfg.vocab_size, d), d, dt))
        self.ssm_blocks = nn.ModuleList(
            nn.ModuleList(S.ssm_block(gen, cfg) for _ in range(period))
            for _ in range(apps))
        self.final_norm = frozen(torch.zeros((d,), dtype=dt,
                                             device=gen.device))
        self.lm_head = frozen(L.dense_init(gen, (d, cfg.vocab_size), d, dt))

    def _embed(self, tokens):
        return self.embed.to(dtype_of(self.cfg))[tokens.long()]

    def _rope(self, positions):
        return L.rope_cos_sin(positions, self.cfg.resolved_head_dim,
                              self.cfg.rope_theta)

    def _mlp(self, x):
        sp, eps = self.shared, self.cfg.norm_eps
        h = L.rms_norm(x, sp.norm2, eps)
        return x + L.gated_mlp(h, sp.mlp["w_gate"], sp.mlp["w_up"],
                               sp.mlp["w_down"])

    def _shared_train(self, x, cos, sin):
        sp = self.shared
        h, _, _ = _attn_train(L.rms_norm(x, sp.norm1, self.cfg.norm_eps),
                              sp.attn, self.cfg, cos, sin)
        return self._mlp(x + h)

    def _group(self, x, group, cos, sin, remat: bool):
        for bp in group:
            if remat:
                x = checkpoint(S.ssm_layer_train, x, bp, self.cfg,
                               use_reentrant=False)
            else:
                x = S.ssm_layer_train(x, bp, self.cfg)
        return self._shared_train(x, cos, sin)

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False):
        """tokens ``[B, S]`` -> logits ``[B, S, V]``, or ``(hidden,
        lm_head)`` after the final norm with ``return_hidden``."""
        x = self._embed(tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        cos, sin = self._rope(positions)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for group in self.ssm_blocks:
            if remat:
                x = checkpoint(self._group, x, group, cos, sin, True,
                               use_reentrant=False)
            else:
                x = self._group(x, group, cos, sin, False)
        x = L.rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if return_hidden:
            return x, self.lm_head
        return L.lm_head(x, self.lm_head)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, object]:
        cfg, dev = self.cfg, self.device
        apps = n_apps(cfg)
        cache: Dict[str, object] = dict(S.init_ssm_cache(
            cfg, batch, (apps, cfg.shared_attn_period), dev))
        kv = (apps, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache.update(
            k=torch.zeros(kv, dtype=dtype_of(cfg), device=dev),
            v=torch.zeros(kv, dtype=dtype_of(cfg), device=dev),
            pos=torch.full((max_len,), -1, dtype=torch.int32, device=dev),
            cur=0)
        return cache

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """The forward's logits and the reference's prefill cache: state
        zeroed, KV cache empty, ``cur = S``."""
        logits = self(tokens)
        b, s = tokens.shape
        cache = self.init_cache(b, max_len or s)
        cache["cur"] = s
        return logits, cache

    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One token ``[B, 1]`` against the cache (updated in place).
        Returns ``(logits [B, 1, V], cache)`` with ``cur`` advanced."""
        cfg, sp = self.cfg, self.shared
        x = self._embed(tokens)
        b = x.shape[0]
        cur = int(cache["cur"])
        cos, sin = self._rope(torch.full((b, 1), cur, dtype=torch.int32,
                                         device=x.device))
        w = cache["k"].shape[2]
        cache["pos"][cur % w] = cur
        for a, group in enumerate(self.ssm_blocks):
            for j, bp in enumerate(group):
                x = S.ssm_layer_decode(x, bp, cache["conv"][a, j],
                                       cache["ssm"][a, j], cfg)
            h = _attn_decode(L.rms_norm(x, sp.norm1, cfg.norm_eps), sp.attn,
                             cfg, cos, sin, cache["k"][a], cache["v"][a],
                             cache["pos"], cur)
            x = self._mlp(x + h)
        x = L.rms_norm(x, self.final_norm, cfg.norm_eps)
        cache["cur"] = cur + 1
        return L.lm_head(x, self.lm_head), cache
