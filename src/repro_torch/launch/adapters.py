"""Per-family adapters (port of ``repro.launch.adapters``), for the
decoder-only ``dense`` and ``moe`` families:

  init_fn(gen, cfg)                      -> model
  train_hidden(model, batch, cfg)        -> (hidden, head, transpose_head,
                                             targets, loss_mask)
  prefill_fn(model, batch, cfg, max_len) -> (logits, cache)
  decode_fn(model, cache, tokens, cfg)   -> (logits, cache)
  init_cache_fn(model, batch, max_len)   -> cache

The reference's pytree of parameters is the ``Transformer`` module here, so
the functions take the model where the reference takes ``params``; the
dry-run input specs have no counterpart. Other families raise
``NotImplementedError`` (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import FAMILIES, Transformer


def _check(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
            f"item 12); the port serves {FAMILIES}")


def init_fn(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """A model with weights drawn from ``gen``, on ``gen``'s device."""
    _check(cfg)
    return Transformer(cfg, gen)


def _shifted(tokens: torch.Tensor, mask: torch.Tensor):
    """Next-token targets aligned with the unsliced logits: ``target[t] =
    token[t+1]``; the final position is masked out."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    tmask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
    return targets, tmask


def train_hidden(model: Transformer, batch, cfg: ModelConfig):
    """-> ``(hidden [B, S, D], head weight, transpose_head, targets,
    loss_mask)``. The loss path never builds the whole ``[B, S, V]``
    logits: the head projection and the loss run chunked over the
    sequence (``steps.chunked_ce``)."""
    _check(cfg)
    hidden, head = model(batch["tokens"], return_hidden=True)
    targets, tmask = _shifted(batch["tokens"], batch["mask"])
    return hidden, head, False, targets, tmask


def prefill_fn(model: Transformer, batch, cfg: ModelConfig,
               max_len: Optional[int] = None):
    _check(cfg)
    return model.prefill(batch["tokens"], max_len=max_len)


def decode_fn(model: Transformer, cache, tokens, cfg: ModelConfig):
    _check(cfg)
    return model.decode_step(cache, tokens)


def init_cache_fn(model: Transformer, batch: int, max_len: int):
    return model.init_cache(batch, max_len)
