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
and ``prefill_fn``.

The dry-run's input specs, with no allocation: ``abstract_model(cfg)``
builds the model on the ``meta`` device, and ``batch_specs``,
``cache_specs`` and ``decode_token_specs`` return ``(tensors, specs)``:
``meta`` tensors of the inputs' shapes and dtypes (the reference's
``ShapeDtypeStruct``s) and a ``parallel.sharding.Spec`` for each.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import vlm as V
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.ssm import SSMLM
from repro_torch.models.transformer import Transformer
from repro_torch.parallel.sharding import FSDP_AXES, Mesh, Spec

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


# ------------------------------------------------------------ input specs --
class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: what
    ``init_fn`` reads ``.device`` from to place every weight."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_model(cfg: ModelConfig) -> nn.Module:
    """``cfg``'s model on the ``meta`` device: every parameter's shape and
    dtype, no memory (``jax.eval_shape(init_fn)``)."""
    return init_fn(_MetaGenerator(), cfg)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _fsdp(mesh_names) -> Tuple[str, ...]:
    axes = tuple(a for a in FSDP_AXES if a in mesh_names)
    return axes if axes else (mesh_names[0],)


def _maybe(dim: int, axes, mesh: Mesh):
    if axes is None:
        return None
    return axes if dim % mesh.axis_size(axes) == 0 else None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """The train or prefill batch: (``meta`` tensors, specs)."""
    b, s = shape.global_batch, shape.seq_len
    dt = _dt(cfg)
    bspec = _maybe(b, _fsdp(mesh.axis_names), mesh)
    batch, specs = {}, {}

    def put(key, shp, dtype, *spec):
        batch[key], specs[key] = _meta(shp, dtype), Spec(*spec)

    if cfg.family == "vlm":
        n_img = min(VLM_IMAGE_TOKENS, s // 2)
        put("tokens", (b, s - n_img), torch.int32, bspec, None)
        put("image_embeds", (b, n_img, cfg.d_model), dt, bspec, None, None)
        put("mrope_positions", (3, b, s), torch.int32, None, bspec, None)
        put("mask", (b, s - n_img), torch.bool, bspec, None)
    elif cfg.family == "audio":
        put("tokens", (b, s), torch.int32, bspec, None)
        put("frames", (b, cfg.encoder_frames, cfg.d_model), dt, bspec, None,
            None)
        put("mask", (b, s), torch.bool, bspec, None)
    else:
        put("tokens", (b, s), torch.int32, bspec, None)
        put("mask", (b, s), torch.bool, bspec, None)
    return batch, specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                model: Optional[nn.Module] = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Spec]]:
    """A decode cell's cache, filled to ``shape.seq_len``: (``meta``
    tensors from ``init_cache_fn`` on the ``meta`` model, specs). The
    scalar ``cur`` is an int32 ``meta`` scalar, as the reference's
    leaf is."""
    names = mesh.axis_names
    fsdp = _fsdp(names)
    tp = "model" if "model" in names else None
    b, s = shape.global_batch, shape.seq_len
    cache = init_cache_fn(model if model is not None
                          else abstract_model(cfg), b, s)
    cache = {k: (v if isinstance(v, torch.Tensor)
                 else _meta((), torch.int32)) for k, v in cache.items()}

    def spec_for(key: str, leaf: torch.Tensor) -> Spec:
        shp = tuple(leaf.shape)
        if key == "pos" or leaf.dim() == 0:
            return Spec()
        if key in ("k", "v", "cross_k", "cross_v"):
            # [L (or apps), B, W, H, hd]
            _, bb, w, h, _ = shp
            bspec = _maybe(bb, fsdp, mesh)
            hspec = _maybe(h, tp, mesh) if tp else None
            wspec = None
            if hspec is None and tp:
                wspec = _maybe(w, tp, mesh)
            if bspec is None and wspec is None:
                # B = 1 long context: spread the sequence over fsdp
                wspec = _maybe(w, fsdp, mesh)
            return Spec(None, bspec, wspec, hspec, None)
        if key == "conv":
            # [..., B, W-1, C]
            bspec = _maybe(shp[-3], fsdp, mesh)
            cspec = _maybe(shp[-1], tp, mesh) if tp else None
            return Spec(*(None,) * (leaf.dim() - 3), bspec, None, cspec)
        if key == "ssm":
            # [..., B, H, P, N]
            bspec = _maybe(shp[-4], fsdp, mesh)
            hspec = _maybe(shp[-3], tp, mesh) if tp else None
            return Spec(*(None,) * (leaf.dim() - 4), bspec, hspec, None,
                        None)
        return Spec()

    return cache, {k: spec_for(k, v) for k, v in cache.items()}


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh
                       ) -> Tuple[torch.Tensor, Spec]:
    b = shape.global_batch
    bspec = _maybe(b, _fsdp(mesh.axis_names), mesh)
    return _meta((b, 1), torch.int32), Spec(bspec, None)
