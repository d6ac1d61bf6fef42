"""AdamW with decoupled weight decay, global-norm clipping, a cosine
schedule and a configurable moment dtype (port of ``repro.optim.adamw``).

Parameters, gradients and moments are mappings of names to tensors (a
model's ``dict(named_parameters())``). The reference's arithmetic is
written out element by element, in f32, and cast back to each leaf's
dtype: bias corrections ``1 - b**step``, ``delta = mhat / (sqrt(nhat) +
1e-8)``, decay ``lr * (delta + wd * p)`` on matrices only, the global norm
over f32 squares. ``torch.optim.AdamW`` is not used: it decays every leaf,
and as a separate multiply before the step, which rounds bf16 parameters
differently.

``apply_updates`` writes the parameters and the moments **in place**
(under ``torch.no_grad()``) and keeps the step counter on the device: it
reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig

Tree = Mapping[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar on the parameters' device
    mu: Tree                 # first moments, one a parameter
    nu: Tree                 # second moments


def init_state(params: Tree, cfg: TrainConfig,
               moment_dtype: torch.dtype = torch.float32) -> AdamWState:
    """Zero moments in ``moment_dtype`` beside each parameter."""
    del cfg
    device = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
             for k, p in params.items()}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=zeros,
        nu={k: torch.zeros_like(z) for k, z in zeros.items()},
    )


def cosine_lr(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``learning_rate``, then a cosine decay to 10 % of
    it at ``total_steps``; f32 on the step's device."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def _global_norm(grads: Tree) -> torch.Tensor:
    # the reference sums the leaves in its pytree order (sorted keys)
    sq = sum(torch.sum(torch.square(grads[k].float())) for k in sorted(grads))
    return torch.sqrt(sq)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def _clip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[dict, torch.Tensor]:
    """``(grads scaled to a global norm of at most max_norm, the norm)``;
    each leaf keeps its dtype."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return {k: _clip(g, scale) for k, g in grads.items()}, gnorm


@torch.no_grad()
def apply_updates(params: Tree, grads: Tree, state: AdamWState,
                  cfg: TrainConfig, ndims: Optional[Mapping[str, int]] = None
                  ) -> Tuple[Tree, AdamWState, torch.Tensor, torch.Tensor]:
    """One clipped AdamW step. Returns ``(params, state, lr, grad_norm)``:
    ``params`` and the state's moments are the mappings given, updated in
    place; the state's step is a new device scalar.

    ``ndims`` gives the rank that the decay rule reads for a leaf, where it
    is not the tensor's own: the reference stacks a model's blocks
    ``[L, ...]``, so a block's norm scale is a matrix there and decays
    (``Transformer.reference_ndims``)."""
    # clip_by_global_norm, one leaf at a time: no second copy of the
    # gradients is held
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)
    for k, p in params.items():
        g, m, n = grads[k], state.mu[k], state.nu[k]
        gf = _clip(g, scale).float()
        mf = m.float() * b1 + gf * (1 - b1)
        nf = n.float() * b2 + gf * gf * (1 - b2)
        mhat = mf / c1
        nhat = nf / c2
        delta = mhat / (torch.sqrt(nhat) + 1e-8)
        # decoupled weight decay on matrices only (ndim >= 2)
        ndim = p.dim() if ndims is None else ndims.get(k, p.dim())
        wd = cfg.weight_decay if ndim >= 2 else 0.0
        pf = p.float()
        p.copy_(pf - lr * (delta + wd * pf))
        m.copy_(mf)
        n.copy_(nf)
    return params, AdamWState(step, state.mu, state.nu), lr, gnorm
