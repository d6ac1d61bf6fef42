"""Gradient compression for the cross-rank reduction (port of
``repro.parallel.collectives``).

``compressed_psum`` casts the gradient tree's f32 leaves to bf16 before
the all-reduce and back after: half the bytes of the gradient reduction
(data-parallel training's largest collective) for about 8 mantissa bits,
which AdamW's normaliser absorbs. ``TrainConfig.grad_compression="bf16"``
selects it in the sharded train step (``launch.train``).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.distributed as dist


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def compress_tree(grads: Any, mode: str) -> Any:
    if mode == "bf16":
        return _map(grads, lambda g: g.to(torch.bfloat16)
                    if g.dtype == torch.float32 else g)
    return grads


def decompress_tree(grads: Any, mode: str) -> Any:
    if mode == "bf16":
        return _map(grads, lambda g: g.to(torch.float32)
                    if g.dtype == torch.bfloat16 else g)
    return grads


def compressed_psum(grads: Any, group=None, mode: str = "bf16") -> Any:
    """The sum over ``group``'s ranks of each leaf of ``grads`` (nested
    dicts of tensors), reduced in bf16 when ``mode == "bf16"``; the
    reference's ``psum`` over a ``shard_map`` axis. Each leaf that
    compression does not copy is summed where it lies: a caller that
    keeps its input passes a copy."""
    def psum(g):
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g

    return decompress_tree(_map(compress_tree(grads, mode), psum), mode)
