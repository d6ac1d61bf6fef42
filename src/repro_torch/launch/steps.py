"""Serving step factories (port of ``repro.launch.steps``): ``prefill_step``
and ``serve_step``. The train step waits for the train path (ROADMAP queue
1, item 12). Both run under ``torch.no_grad()``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import adapters


def make_prefill_step(cfg: ModelConfig):
    """Serving prefill: fill the KV cache and return the last position's
    logits (what the next decode step consumes)."""
    @torch.no_grad()
    def prefill_step(model, batch):
        logits, cache = adapters.prefill_fn(model, batch, cfg)
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One new token for every sequence of the batch, greedy: the first
    index of the largest logit, as ``jnp.argmax`` picks."""
    @torch.no_grad()
    def serve_step(model, cache, tokens):
        logits, cache = adapters.decode_fn(model, cache, tokens, cfg)
        next_tokens = torch.argmax(logits[:, -1], dim=-1)
        return next_tokens.to(torch.int32)[:, None], cache

    return serve_step
