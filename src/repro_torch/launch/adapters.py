"""Per-family adapters (port of ``repro.launch.adapters``): one interface
over the model zoo.

  init_fn(gen, cfg)                      -> model
  train_hidden(model, batch, cfg)        -> (hidden, head, transpose_head,
                                             targets, loss_mask)
  prefill_fn(model, batch, cfg, max_len) -> (logits, cache)
  decode_fn(model, cache, tokens, cfg)   -> (logits, cache)
  init_cache_fn(model, batch, max_len)   -> cache

The reference's pytree of parameters is the model module here (``dense``,
``moe`` and ``vlm``: ``Transformer``; ``ssm``: ``SSMLM``; ``hybrid``:
``HybridLM``; ``audio``: ``EncDecLM``), so the functions take the model
where the reference takes ``params``. An unknown family raises what the
reference raises: ``KeyError`` from the family lookups of ``init_fn``,
``decode_fn`` and ``init_cache_fn``, ``ValueError`` from ``train_hidden``
and ``prefill_fn``. The dry-run input specs (``batch_specs``,
``cache_specs``, ``decode_token_specs``) wait for ROADMAP queue 1, item
12.3.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import vlm as V
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.ssm import SSMLM
from repro_torch.models.transformer import Transformer

#: the stub vision prefix of the vlm family: 1,024 patches on a 32x32 grid
VLM_IMAGE_TOKENS = 1024
VLM_GRID = (32, 32)

_MODELS = {"dense": Transformer, "moe": Transformer, "vlm": Transformer,
           "audio": EncDecLM, "ssm": SSMLM, "hybrid": HybridLM}


def init_fn(gen: torch.Generator, cfg: ModelConfig) -> nn.Module:
    """A model with weights drawn from ``gen``, on ``gen``'s device."""
    return _MODELS[cfg.family](cfg, gen)


def _shifted(tokens: torch.Tensor, mask: torch.Tensor):
    """Next-token targets aligned with the unsliced logits: ``target[t] =
    token[t+1]``; the final position is masked out."""
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                        dim=1)
    tmask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
    return targets, tmask


def train_hidden(model: nn.Module, batch, cfg: ModelConfig):
    """-> ``(hidden [B, S, D], head weight, transpose_head, targets,
    loss_mask)``. The loss path never builds the whole ``[B, S, V]``
    logits: the head projection and the loss run chunked over the
    sequence (``steps.chunked_ce``). The vlm family's targets and mask are
    padded in front by the image length (no loss on the image prefix); the
    audio family's head is the tied embedding ``[V, D]``, read
    transposed."""
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        hidden, head = model(batch["tokens"], return_hidden=True)
        targets, tmask = _shifted(batch["tokens"], batch["mask"])
        return hidden, head, False, targets, tmask
    if cfg.family == "vlm":
        hidden, head = V.forward(model, batch["tokens"],
                                 batch["image_embeds"],
                                 batch["mrope_positions"], return_hidden=True)
        n_img = batch["image_embeds"].shape[1]
        targets, tmask = _shifted(batch["tokens"], batch["mask"])
        pad_t = targets.new_zeros((targets.shape[0], n_img))
        pad_m = tmask.new_zeros((tmask.shape[0], n_img))
        return (hidden, head, False, torch.cat([pad_t, targets], dim=1),
                torch.cat([pad_m, tmask], dim=1))
    if cfg.family == "audio":
        hidden, head = model(batch["tokens"], batch["frames"],
                             return_hidden=True)
        targets, tmask = _shifted(batch["tokens"], batch["mask"])
        return hidden, head, True, targets, tmask
    raise ValueError(cfg.family)


def prefill_fn(model: nn.Module, batch, cfg: ModelConfig,
               max_len: Optional[int] = None):
    if cfg.family in ("dense", "moe", "ssm", "hybrid"):
        # (the ssm family's O(1) cache ignores max_len)
        return model.prefill(batch["tokens"], max_len=max_len)
    if cfg.family == "vlm":
        return V.prefill(model, batch["tokens"], batch["image_embeds"],
                         batch["mrope_positions"], max_len=max_len)
    if cfg.family == "audio":
        return model.prefill(batch["tokens"], batch["frames"],
                             max_len=max_len)
    raise ValueError(cfg.family)


def decode_fn(model: nn.Module, cache, tokens, cfg: ModelConfig):
    _MODELS[cfg.family]          # an unknown family raises KeyError
    return model.decode_step(cache, tokens)


def init_cache_fn(model: nn.Module, batch: int, max_len: int):
    _MODELS[model.cfg.family]    # an unknown family raises KeyError
    return model.init_cache(batch, max_len)
