"""Qwen2-VL backbone, family ``vlm`` (port of ``repro.models.vlm``).

The model is the transformer backbone (``models/transformer.py`` with
``cfg.mrope_sections`` set); the vision tower is a stub: precomputed patch
embeddings ``[B, S_img, D]`` are prefixed to the text tokens, and M-RoPE
position ids ``[3, B, S]`` (temporal / height / width streams) drive the
rotary angles. The functions take the ``Transformer`` where the reference
takes ``params``.

Decode gives each new token position ``cur = S_img + S_text`` on all three
streams (``Transformer.decode_step``), while prefill placed text at
``max(gh, gw) + i``: the reference's positions, copied as they are.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.transformer import Transformer


def make_mrope_positions(batch: int, seq: int, num_image_tokens: int,
                         grid_hw: Tuple[int, int], device=None
                         ) -> torch.Tensor:
    """``[3, B, S]`` int32 (t, h, w) positions: image patches get
    ``(0, y, x)``; text tokens continue with equal t/h/w ids from
    ``max(gh, gw)`` (the Qwen2-VL scheme)."""
    gh, gw = grid_hw
    if gh * gw != num_image_tokens:
        raise ValueError(f"grid {grid_hw} does not hold {num_image_tokens} "
                         "image tokens")

    def ar(n):
        return torch.arange(n, dtype=torch.int32, device=device)

    ys = torch.repeat_interleave(ar(gh), gw)
    xs = ar(gw).repeat(gh)
    text = max(gh, gw) + ar(seq - num_image_tokens)
    zeros = torch.zeros(num_image_tokens, dtype=torch.int32, device=device)
    pos = torch.stack([torch.cat([zeros, text]), torch.cat([ys, text]),
                       torch.cat([xs, text])])               # [3, S]
    return pos[:, None, :].expand(3, batch, seq)


def forward(model: Transformer, tokens: torch.Tensor,
            image_embeds: torch.Tensor, mrope_positions: torch.Tensor,
            return_hidden: bool = False):
    """tokens ``[B, S_text]``, image_embeds ``[B, S_img, D]``,
    mrope_positions ``[3, B, S_img + S_text]`` -> logits over the whole
    sequence (or ``(hidden, head)``)."""
    return model(tokens, return_hidden=return_hidden,
                 mrope_positions=mrope_positions, extra_embeds=image_embeds)


def prefill(model: Transformer, tokens: torch.Tensor,
            image_embeds: torch.Tensor, mrope_positions: torch.Tensor,
            max_len: Optional[int] = None):
    return model.prefill(tokens, max_len=max_len,
                         mrope_positions=mrope_positions,
                         extra_embeds=image_embeds)


def decode_step(model: Transformer, cache, tokens: torch.Tensor):
    return model.decode_step(cache, tokens)
