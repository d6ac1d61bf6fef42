"""Whisper-style encoder-decoder, family ``audio`` (arXiv:2212.04356; port
of ``repro.models.encdec``).

The conv frontend is a stub: the model takes precomputed mel-frame
embeddings ``[B, T, D]`` (what the two stride-2 convs would produce).
Encoder: bidirectional MHA and a GELU MLP, sinusoidal positions. Decoder:
causal self-attention, cross-attention on the encoder output and a GELU
MLP, learned positions, the tied embedding as head (transposed).

Parameters keep the reference's names and layout: ``enc_blocks.i`` and
``dec_blocks.i`` are leaf ``i`` of the reference's stacks, norms are
``{scale, bias}`` LayerNorms, the cross-attention's weights carry the
``cross_`` prefix. The cache is ``{"k", "v": [L, B, max_len, H, hd],
"cross_k", "cross_v": [L, B, T, H, hd], "pos": int32[max_len], "cur":
int}``. ``prefill`` fills only the cross K/V; the decoder's self-attention
cache stays empty (``pos`` all -1), as in the reference. ``decode_step``
updates the cache in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import dtype_of
from repro_torch.models.transformer import LM, frozen

MAX_DECODER_POS = 65536


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal encoder positions ``[length, channels]`` f32."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(
        np.float32)


def _attn(gen, cfg: ModelConfig, dt, prefix: str = ""):
    d, hd = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    shapes = {"wq": (d, hd), "wk": (d, hd), "wv": (d, hd), "wo": (hd, d)}
    return frozen({prefix + k: L.dense_init(gen, s, s[0], dt)
                   for k, s in shapes.items()})


def _mlp(gen, cfg: ModelConfig, dt):
    d, f = cfg.d_model, cfg.d_ff
    return frozen({"w_gate": L.dense_init(gen, (d, f), d, dt),
                   "w_down": L.dense_init(gen, (f, d), f, dt)})


def _ln(cfg: ModelConfig, dt, device):
    d = cfg.d_model
    return frozen({"scale": torch.ones((d,), dtype=dt, device=device),
                   "bias": torch.zeros((d,), dtype=dt, device=device)})


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg)
        self.attn = _attn(gen, cfg, dt)
        self.mlp = _mlp(gen, cfg, dt)
        self.ln1 = _ln(cfg, dt, gen.device)
        self.ln2 = _ln(cfg, dt, gen.device)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg)
        self.self_attn = _attn(gen, cfg, dt)
        self.cross_attn = _attn(gen, cfg, dt, prefix="cross_")
        self.mlp = _mlp(gen, cfg, dt)
        self.ln1 = _ln(cfg, dt, gen.device)
        self.ln2 = _ln(cfg, dt, gen.device)
        self.ln3 = _ln(cfg, dt, gen.device)


def _norm(x, ln, cfg: ModelConfig):
    return L.layer_norm(x, ln["scale"], ln["bias"], cfg.norm_eps)


def _heads(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return t.reshape(t.shape[0], t.shape[1], cfg.num_heads,
                     cfg.resolved_head_dim)


def _mha(x, ctx, p, cfg: ModelConfig, causal: bool, prefix: str = ""):
    b, s, _ = x.shape
    q = _heads(x @ p[prefix + "wq"].to(x.dtype), cfg)
    k = _heads(ctx @ p[prefix + "wk"].to(x.dtype), cfg)
    v = _heads(ctx @ p[prefix + "wv"].to(x.dtype), cfg)
    o = L.gqa_attention_chunked(q, k, v, causal=causal)
    return o.reshape(b, s, -1) @ p[prefix + "wo"].to(x.dtype)


def _gelu_mlp(x, p):
    return L.gated_mlp(x, p["w_gate"], None, p["w_down"], act="gelu")


def _plain_attn(q, k, v):
    """One query against the encoder's K/V, softmax in f32."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pr = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", pr, v.float()).to(q.dtype)


class EncDecLM(LM):
    """The ``audio`` family's encoder-decoder (whisper). Weights are drawn
    from ``gen`` on its device, created frozen. With ``cfg.remat`` and grad
    enabled, each encoder and decoder block runs under
    ``torch.utils.checkpoint``."""

    #: stacked dims of each top-level key in the reference's pytree
    STACK_DEPTH = {"enc_blocks": 1, "dec_blocks": 1}

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dt, d, dev = dtype_of(cfg), cfg.d_model, gen.device
        self.embed = frozen(L.dense_init(gen, (cfg.vocab_size, d), d, dt))
        self.pos_embed = frozen(L.dense_init(gen, (MAX_DECODER_POS, d), d,
                                             dt))
        self.enc_blocks = nn.ModuleList(EncoderBlock(cfg, gen)
                                        for _ in range(cfg.encoder_layers))
        self.enc_ln = _ln(cfg, dt, dev)
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg, gen)
                                        for _ in range(cfg.num_layers))
        self.dec_ln = _ln(cfg, dt, dev)

    def _run(self, fn, x, *args):
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, x, *args, use_reentrant=False)
        return fn(x, *args)

    def _enc_block(self, x, bp):
        cfg = self.cfg
        h = _norm(x, bp.ln1, cfg)
        x = x + _mha(h, h, bp.attn, cfg, causal=False)
        return x + _gelu_mlp(_norm(x, bp.ln2, cfg), bp.mlp)

    def _dec_block(self, x, bp, enc_out):
        cfg = self.cfg
        h = _norm(x, bp.ln1, cfg)
        x = x + _mha(h, h, bp.self_attn, cfg, causal=True)
        h = _norm(x, bp.ln2, cfg)
        x = x + _mha(h, enc_out, bp.cross_attn, cfg, causal=False,
                     prefix="cross_")
        return x + _gelu_mlp(_norm(x, bp.ln3, cfg), bp.mlp)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames ``[B, T, D]`` (the stubbed frontend's output) ->
        ``[B, T, D]``."""
        dt = dtype_of(self.cfg)
        _, t, d = frames.shape
        pos = torch.from_numpy(sinusoids(t, d)).to(frames.device, dt)
        x = L.batch_shard(frames.to(dt) + pos[None])
        for bp in self.enc_blocks:
            x = self._run(self._enc_block, x, bp)
        return _norm(x, self.enc_ln, self.cfg)

    def _decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor):
        dt = dtype_of(self.cfg)
        s = tokens.shape[1]
        x = L.batch_shard(self.embed.to(dt)[tokens.long()]
                          + self.pos_embed.to(dt)[:s][None])
        for bp in self.dec_blocks:
            x = self._run(self._dec_block, x, bp, enc_out)
        return _norm(x, self.dec_ln, self.cfg)

    def forward(self, tokens: torch.Tensor, frames: torch.Tensor,
                return_hidden: bool = False):
        """Teacher-forced forward -> logits ``[B, S, V]``, or ``(hidden,
        embed)`` with ``return_hidden`` (the head is the tied embedding
        ``[V, D]``, read transposed)."""
        x = self._decode_train(tokens, self.encode(frames))
        if return_hidden:
            return x, self.embed
        return L.lm_head(x, self.embed, transpose=True)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, object]:
        cfg, dev, dt = self.cfg, self.device, dtype_of(self.cfg)
        h, hd, ld = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
        t = cfg.encoder_frames

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        return {"k": zeros(ld, batch, max_len, h, hd),
                "v": zeros(ld, batch, max_len, h, hd),
                "cross_k": zeros(ld, batch, t, h, hd),
                "cross_v": zeros(ld, batch, t, h, hd),
                "pos": torch.full((max_len,), -1, dtype=torch.int32,
                                  device=dev),
                "cur": 0}

    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """Encode the audio, compute each layer's cross K/V, teacher-force
        the prompt. The self-attention cache stays empty, as in the
        reference; ``cur = S``."""
        enc_out = self.encode(frames)
        b, s = tokens.shape
        ck = torch.stack([_heads(enc_out @ bp.cross_attn["cross_wk"].to(
            enc_out.dtype), self.cfg) for bp in self.dec_blocks])
        cv = torch.stack([_heads(enc_out @ bp.cross_attn["cross_wv"].to(
            enc_out.dtype), self.cfg) for bp in self.dec_blocks])
        logits = L.lm_head(self._decode_train(tokens, enc_out), self.embed,
                           transpose=True)
        cache = self.init_cache(b, max_len or s)
        cache.update(cross_k=ck, cross_v=cv, cur=s)
        return logits, cache

    def decode_step(self, cache: Dict[str, object], tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """One token ``[B, 1]`` against the cache (updated in place):
        causal self-attention over the written slots, cross-attention over
        the encoder's K/V (softmax in f32), the learned position
        ``pos_embed[cur]``."""
        cfg, dt = self.cfg, dtype_of(self.cfg)
        cur = int(cache["cur"])
        x = (self.embed.to(dt)[tokens.long()]
             + self.pos_embed.to(dt)[cur][None, None])
        b = x.shape[0]
        w = cache["k"].shape[2]
        slot = cur % w
        cache["pos"][slot] = cur
        for i, bp in enumerate(self.dec_blocks):
            p = bp.self_attn
            h = _norm(x, bp.ln1, cfg)
            q = _heads(h @ p["wq"].to(x.dtype), cfg)
            cache["k"][i][:, slot] = _heads(h @ p["wk"].to(x.dtype), cfg)[:, 0]
            cache["v"][i][:, slot] = _heads(h @ p["wv"].to(x.dtype), cfg)[:, 0]
            o = L.gqa_attention_decode(q, cache["k"][i], cache["v"][i],
                                       cache["pos"], cur)
            x = x + o.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
            p = bp.cross_attn
            h2 = _norm(x, bp.ln2, cfg)
            q2 = _heads(h2 @ p["cross_wq"].to(x.dtype), cfg)
            o2 = _plain_attn(q2, cache["cross_k"][i], cache["cross_v"][i])
            x = x + o2.reshape(b, 1, -1) @ p["cross_wo"].to(x.dtype)
            x = x + _gelu_mlp(_norm(x, bp.ln3, cfg), bp.mlp)
        x = _norm(x, self.dec_ln, cfg)
        cache["cur"] = cur + 1
        return L.lm_head(x, self.embed, transpose=True), cache
