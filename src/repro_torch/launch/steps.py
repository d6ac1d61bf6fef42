"""Step factories (port of ``repro.launch.steps``): ``train_step`` (forward,
backward and AdamW, with microbatch accumulation), ``prefill_step`` and
``serve_step``. The serving steps run under ``torch.no_grad()``."""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.launch import adapters
from repro_torch.models import layers as L
from repro_torch.optim import adamw


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor,
              z_loss: float) -> torch.Tensor:
    """Per-position cross-entropy (plus the z-loss), in f32."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    ce = logz - gold
    if z_loss:
        ce = ce + z_loss * torch.square(logz)
    return ce


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, z_loss: float = 0.0) -> torch.Tensor:
    """Mean masked cross-entropy over the whole ``[B, S, V]`` logits,
    upcast to f32; ``z_loss`` adds ``z_loss * logsumexp**2``."""
    ce = _ce_terms(logits, targets, z_loss)
    m = mask.float()
    return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)


CE_CHUNK = 1024


def _chunk_ce(h_c, head_w, t_c, m_c, transpose_head: bool, z_loss: float):
    logits = L.lm_head(h_c, head_w, transpose=transpose_head)
    ce = _ce_terms(logits, t_c, z_loss)
    mf = m_c.float()
    return torch.sum(ce * mf), torch.sum(mf)


def chunked_ce(hidden, head_w, transpose_head: bool, targets, mask,
               z_loss: float = 0.0, chunk: int = CE_CHUNK) -> torch.Tensor:
    """Head projection and cross-entropy over sequence chunks of ``chunk``
    positions (the whole sequence where ``chunk`` does not divide it). With
    grad enabled each chunk runs under a checkpoint, so backward recomputes
    its logits: the ``[B, S, V]`` logits, the largest activation of LM
    training, never exist whole, only ``[B, chunk, V]`` at a time."""
    s = hidden.shape[1]
    c = min(chunk, s)
    if s % c:
        c = s
    ce_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    m_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        part = (hidden[:, i * c:(i + 1) * c], head_w,
                targets[:, i * c:(i + 1) * c], mask[:, i * c:(i + 1) * c],
                transpose_head, z_loss)
        if torch.is_grad_enabled():
            ce, m = checkpoint(_chunk_ce, *part, use_reentrant=False)
        else:
            ce, m = _chunk_ce(*part)
        ce_sum = ce_sum + ce
        m_sum = m_sum + m
    return ce_sum / torch.clamp(m_sum, min=1.0)


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    """``loss_fn(model, batch) -> loss``: the chunked cross-entropy of the
    model's next-token predictions."""
    def loss_fn(model, batch):
        hidden, head, transpose_head, targets, mask = adapters.train_hidden(
            model, batch, cfg)
        return chunked_ce(hidden, head, transpose_head, targets, mask,
                          tcfg.z_loss)

    return loss_fn


def _microbatch(key: str, v: torch.Tensor, i: int, mb: int) -> torch.Tensor:
    """Slice ``i`` of ``mb`` of a batch entry along its batch axis: 1 for
    the ``[3, B, S]`` M-RoPE position streams, 0 otherwise."""
    axis = 1 if key == "mrope_positions" else 0
    n = v.shape[axis] // mb
    return v.narrow(axis, i * n, n)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``.

    The step updates the model's parameters in place (the reference returns
    new ones) and turns their gradients on. ``metrics`` holds ``loss``,
    ``lr``, ``grad_norm`` and ``step`` as device scalars: the step reads
    nothing back to the host. ``microbatches > 1`` accumulates the
    gradients of equal slices of the batch in ``acc_dtype`` (bf16 when the
    moments are bf16, f32 otherwise) and divides by their count, as the
    reference's scan does; the gradients then reach AdamW in that dtype.
    """
    loss_fn = make_loss_fn(cfg, tcfg)
    acc_dtype = (torch.bfloat16 if cfg.opt_state_dtype == "bfloat16"
                 else torch.float32)

    def grads_of(model, names, params, batch):
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), dict(zip(names, grads))

    def train_step(model, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]):
        named = dict(model.named_parameters())
        names, params = list(named), list(named.values())
        for p in params:
            p.requires_grad_(True)
        mb = tcfg.microbatches
        if mb > 1:
            gsum = {k: torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                    for k, p in named.items()}
            lsum = 0.0
            for i in range(mb):
                mbatch = {k: _microbatch(k, v, i, mb)
                          for k, v in batch.items()}
                loss, grads = grads_of(model, names, params, mbatch)
                for k, g in grads.items():
                    gsum[k] += g.to(acc_dtype)
                lsum = lsum + loss
                del grads
            grads = {k: g / mb for k, g in gsum.items()}
            loss = lsum / mb
        else:
            loss, grads = grads_of(model, names, params, batch)
        _, opt_state, lr, gnorm = adamw.apply_updates(
            named, grads, opt_state, tcfg, ndims=model.reference_ndims())
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm,
                   "step": opt_state.step}
        return opt_state, metrics

    return train_step


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
