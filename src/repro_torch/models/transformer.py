"""Decoder-only transformer LM, families ``dense`` (llama / qwen), ``moe``
(mixtral / granite) and the ``vlm`` backbone (qwen2-vl: M-RoPE and a
stubbed vision frontend, ``models/vlm.py``) (port of
``repro.models.transformer``).

``Transformer`` is an ``nn.Module`` with one ``Block`` per layer; each
block keeps its weights in ``nn.ParameterDict``s under the reference's
names and layouts (``attn.wq`` is ``[D, Hq*hd]``, ``mlp.experts_gate`` is
``[E, D, F]``, ...), so the reference's stacked ``[L, ...]`` leaf ``i`` is
block ``i``'s parameter (``interop.params_from_arrays``).

Three entry points, as in the reference:

* ``forward(tokens)``         -> logits ``[B, S, V]``, or ``(hidden, head)``
  after the final norm with ``return_hidden=True`` (the training loss
  path, which never builds the whole logits)
* ``prefill(tokens, max_len)`` -> ``(logits, cache)``, the KV cache filled;
  a rolling window-sized cache when ``cfg.sliding_window > 0``
* ``decode_step(cache, tokens)`` -> ``(logits [B, 1, V], cache)``

The cache is ``{"k", "v": [L, B, W, Hkv, hd], "pos": int32[W], "cur": int}``.
``decode_step`` writes the new k/v and position into the cache it is
given, **in place** (the reference returns a new cache), and returns it
with ``cur`` advanced. Attention runs the plain chunked
``layers.gqa_attention_chunked``, as the reference's model does; the flash
kernel is reached through its own entry point. Serving needs no remat, and
the port runs it under ``torch.no_grad()``.

Training: the weights are created frozen (``requires_grad=False``, as
serving wants them); the train step turns their gradients on. With
``cfg.remat`` and grad enabled, ``forward`` runs each block under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint(block)``):
only the block's input is kept, and backward recomputes the block, the
MoE routing included. The routing is deterministic, so the recompute
routes every token as the forward did.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import dtype_of, init_moe_mlp, moe_mlp

FAMILIES = ("dense", "moe", "vlm")


def frozen(t):
    """A parameter (``requires_grad=False``) of a tensor, or a
    ``nn.ParameterDict`` of such of a dict of tensors."""
    if isinstance(t, dict):
        return nn.ParameterDict({k: frozen(v) for k, v in t.items()})
    return nn.Parameter(t, requires_grad=False)


class LM(nn.Module):
    """What the port's LMs share: an ``embed`` parameter on the model's
    device, and the reference's stacked layout, ``STACK_DEPTH``: the
    stacked leading dims of each top-level key of the reference's pytree
    (``blocks`` is ``[L, ...]``, hybrid's ``ssm_blocks`` ``[n_apps,
    period, ...]``)."""

    STACK_DEPTH: Dict[str, int] = {}

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reference_ndims(self) -> Dict[str, int]:
        """Each parameter's rank in the reference's pytree: its own plus
        the stacked dims of its top-level key (what AdamW's matrices-only
        decay reads: a stacked norm scale is a matrix there, and
        decays)."""
        depth = self.STACK_DEPTH
        return {k: p.dim() + depth.get(k.split(".")[0], 0)
                for k, p in self.named_parameters()}


class Block(nn.Module):
    """One layer: pre-norm attention and pre-norm MLP (dense or MoE)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt, device = dtype_of(cfg), gen.device
        d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        hd = cfg.resolved_head_dim

        def dense(shape, fan_in):
            return L.dense_init(gen, shape, fan_in, dt)

        attn = {
            "wq": dense((d, hq * hd), d),
            "wk": dense((d, hkv * hd), d),
            "wv": dense((d, hkv * hd), d),
            "wo": dense((hq * hd, d), hq * hd),
        }
        if cfg.qkv_bias:
            for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
                attn[name] = torch.zeros((width * hd,), dtype=dt,
                                         device=device)
        if cfg.num_experts > 0:
            mlp = init_moe_mlp(gen, cfg)
        else:
            mlp = {
                "w_gate": dense((d, cfg.d_ff), d),
                "w_up": dense((d, cfg.d_ff), d),
                "w_down": dense((cfg.d_ff, d), cfg.d_ff),
            }
        self.attn = frozen(attn)
        self.mlp = frozen(mlp)
        self.norm1 = frozen(torch.zeros((d,), dtype=dt, device=device))
        self.norm2 = frozen(torch.zeros((d,), dtype=dt, device=device))


def _qkv(x, p, cfg: ModelConfig):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def _attn_train(x, p, cfg: ModelConfig, cos, sin):
    b, s, _ = x.shape
    q, k, v = _qkv(x, p, cfg)
    q = L.apply_rotary(q, cos, sin)
    k = L.apply_rotary(k, cos, sin)
    out = L.gqa_attention_chunked(q, k, v, causal=True,
                                  window=cfg.sliding_window)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype), k, v


def _attn_decode(x, p, cfg: ModelConfig, cos, sin, k_cache, v_cache,
                 cache_pos, cur: int):
    """x [B, 1, D]; writes this token's k/v into slot ``cur % W`` of
    ``k_cache``/``v_cache`` [B, W, Hkv, hd] in place."""
    b = x.shape[0]
    q, k, v = _qkv(x, p, cfg)
    q = L.apply_rotary(q, cos, sin)
    k = L.apply_rotary(k, cos, sin)
    slot = cur % k_cache.shape[1]
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    out = L.gqa_attention_decode(q, k_cache, v_cache, cache_pos, cur,
                                 window=cfg.sliding_window)
    return out.reshape(b, 1, -1) @ p["wo"].to(x.dtype)


def _mlp(x, p, cfg: ModelConfig):
    if cfg.num_experts > 0:
        return moe_mlp(x, p, cfg)
    return L.gated_mlp(x, p["w_gate"], p["w_up"], p["w_down"], act=cfg.act)


def cache_window(cfg: ModelConfig, max_len: int) -> int:
    """Cache length: rolling window-sized for sliding-window archs."""
    if cfg.sliding_window > 0:
        return min(max_len, cfg.sliding_window)
    return max_len


class Transformer(LM):
    """Decoder-only LM of the ``dense``, ``moe`` and ``vlm`` families.

    ``gen`` draws every weight on its own device, one tensor at a time in
    f32 and then cast to ``cfg.dtype`` (the model never exists whole in
    f32); norms and biases start at zero, as in the reference."""

    #: stacked dims of each top-level key in the reference's pytree
    STACK_DEPTH = {"blocks": 1}

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not a transformer's; "
                             f"Transformer builds {FAMILIES}")
        self.cfg = cfg
        dt = dtype_of(cfg)
        d = cfg.d_model
        self.embed = frozen(L.dense_init(gen, (cfg.vocab_size, d), d, dt))
        self.blocks = nn.ModuleList(Block(cfg, gen)
                                    for _ in range(cfg.num_layers))
        self.final_norm = frozen(torch.zeros((d,), dtype=dt,
                                             device=gen.device))
        if not cfg.tie_embeddings:
            self.lm_head = frozen(L.dense_init(gen, (d, cfg.vocab_size), d,
                                               dt))

    # ---------------------------------------------------------------- util
    def _rope(self, positions, mrope_positions=None):
        cfg = self.cfg
        if cfg.mrope_sections and mrope_positions is not None:
            return L.mrope_cos_sin(mrope_positions, cfg.resolved_head_dim,
                                   cfg.rope_theta, cfg.mrope_sections)
        return L.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)

    def _logits(self, x):
        x = L.rms_norm(x, self.final_norm)
        if self.cfg.tie_embeddings:
            return L.lm_head(x, self.embed, transpose=True)
        return L.lm_head(x, self.lm_head)

    def _embed(self, tokens, extra_embeds=None):
        x = self.embed.to(dtype_of(self.cfg))[tokens.long()]
        if extra_embeds is not None:
            # the vlm stub: precomputed patch embeddings before the text
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return L.batch_shard(x)

    def _positions(self, x):
        b, s, _ = x.shape
        return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)

    # ------------------------------------------------------------- forward
    def _block(self, x, blk, cos, sin):
        h, _, _ = _attn_train(L.rms_norm(x, blk.norm1), blk.attn, self.cfg,
                              cos, sin)
        x = x + h
        x = x + _mlp(L.rms_norm(x, blk.norm2), blk.mlp, self.cfg)
        return L.seq_shard(x) if self.cfg.seq_sharded_residual else x

    def forward(self, tokens: torch.Tensor, return_hidden: bool = False,
                mrope_positions: Optional[torch.Tensor] = None,
                extra_embeds: Optional[torch.Tensor] = None):
        """Full-sequence forward: tokens [B, S] -> logits [B, S, V]; with
        ``return_hidden``, ``(hidden [B, S, D], head)`` after the final
        norm, ``head`` ``[D, V]`` (``embed.T`` when the embeddings are
        tied). The vlm family passes ``extra_embeds [B, S_img, D]``,
        prefixed to the text, and ``mrope_positions [3, B, S_img + S]``."""
        x = self._embed(tokens, extra_embeds)
        cos, sin = self._rope(self._positions(x), mrope_positions)
        remat = self.cfg.remat and torch.is_grad_enabled()
        if self.cfg.seq_sharded_residual:
            x = L.seq_shard(x)
        for blk in self.blocks:
            if remat:
                x = checkpoint(self._block, x, blk, cos, sin,
                               use_reentrant=False)
            else:
                x = self._block(x, blk, cos, sin)
        if return_hidden:
            head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
            return L.rms_norm(x, self.final_norm), head
        return self._logits(x)

    # --------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int) -> Dict[str, object]:
        cfg = self.cfg
        w = cache_window(cfg, max_len)
        shape = (cfg.num_layers, batch, w, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dt, dev = dtype_of(cfg), self.device
        return {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.full((w,), -1, dtype=torch.int32, device=dev),
            "cur": 0,
        }

    def prefill(self, tokens: torch.Tensor, max_len: Optional[int] = None,
                mrope_positions: Optional[torch.Tensor] = None,
                extra_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """Forward pass that also fills the KV cache. With ``s >= w`` the
        cache keeps the last ``w`` positions in the rolling layout (slot
        ``pos % w``); otherwise positions ``0..s-1`` and empty slots.
        ``s`` counts the image prefix of ``extra_embeds`` too."""
        x = self._embed(tokens, extra_embeds)
        s = x.shape[1]
        w = cache_window(self.cfg, max_len or s)
        cos, sin = self._rope(self._positions(x), mrope_positions)
        ks, vs = [], []
        for blk in self.blocks:
            h, k, v = _attn_train(L.rms_norm(x, blk.norm1), blk.attn,
                                  self.cfg, cos, sin)
            x = x + h
            x = x + _mlp(L.rms_norm(x, blk.norm2), blk.mlp, self.cfg)
            if s >= w:
                shift = (s - w) % w
                k = torch.roll(k[:, s - w:], shift, dims=1)
                v = torch.roll(v[:, s - w:], shift, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, w - s)
                k = torch.nn.functional.pad(k, pad)
                v = torch.nn.functional.pad(v, pad)
            ks.append(k)
            vs.append(v)
        logits = self._logits(x)
        idx = torch.arange(w, dtype=torch.int32, device=x.device)
        if s >= w:
            start = s - w
            pos = start + torch.remainder(idx - start, w)
        else:
            pos = torch.where(idx < s, idx, -1)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": pos.to(torch.int32), "cur": s}
        return logits, cache

    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One token [B, 1] against the cache (updated in place). Returns
        ``(logits [B, 1, V], cache)`` with ``cache["cur"]`` advanced."""
        x = self._embed(tokens)
        b = x.shape[0]
        cur = int(cache["cur"])
        positions = torch.full((b, 1), cur, dtype=torch.int32,
                               device=x.device)
        # M-RoPE: the new token at position cur on all three streams
        mpos = (torch.full((3, b, 1), cur, dtype=torch.int32,
                           device=x.device)
                if self.cfg.mrope_sections else None)
        cos, sin = self._rope(positions, mpos)
        w = cache["k"].shape[2]
        cache["pos"][cur % w] = cur
        for i, blk in enumerate(self.blocks):
            h = _attn_decode(L.rms_norm(x, blk.norm1), blk.attn, self.cfg,
                             cos, sin, cache["k"][i], cache["v"][i],
                             cache["pos"], cur)
            x = x + h
            x = x + _mlp(L.rms_norm(x, blk.norm2), blk.mlp, self.cfg)
        cache["cur"] = cur + 1
        return self._logits(x), cache
