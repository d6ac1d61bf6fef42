"""Carry the reference's inputs across into the port.

The JAX package's ``WindowSchedule``, ``EdgeList`` and ``StateSpec`` reach
the port as plain numpy arrays and names (e.g. ``dataclasses.asdict`` of a
reference schedule), so the port's kernels can run on the reference's exact
schedule independently of the port's own ``build_window_schedule``. A
model's parameters reach it as the reference's pytree of numpy arrays
(``params_from_arrays``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.statespec import StateSpec
from repro_torch.graphs.types import EdgeList
from repro_torch.graphs.windows import WindowSchedule

_FIELDS = {f.name for f in dataclasses.fields(WindowSchedule)}


def schedule_from_arrays(fields: Mapping[str, Any]) -> WindowSchedule:
    """Build the port's ``WindowSchedule`` from a mapping of its field names
    to numpy arrays and plain values. Unknown field names raise."""
    unknown = set(fields) - _FIELDS
    if unknown:
        raise ValueError(f"unknown WindowSchedule fields {sorted(unknown)}")
    kw = {}
    for name, value in fields.items():
        if value is not None and not isinstance(value, (int, float, str)):
            value = np.asarray(value)
            if value.ndim == 0:
                value = value.item()  # host-sync: ok — numpy scalar
        kw[name] = value
    return WindowSchedule(**kw)


def edges_from_arrays(u, v, n: int) -> EdgeList:
    """An ``EdgeList`` of CPU int32 tensors from array-likes."""
    return EdgeList(torch.from_numpy(np.asarray(u, np.int32).copy()),
                    torch.from_numpy(np.asarray(v, np.int32).copy()), int(n))


def spec_from_names(**names: str) -> StateSpec:
    """A ``StateSpec`` from the reference spec's dtype names, e.g.
    ``spec_from_names(**dataclasses.asdict(ref_spec))``."""
    return StateSpec(**names)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16; f32 holds it exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _expect(tree: Mapping[str, Any], keys, where: str) -> None:
    got, want = set(tree), set(keys)
    if got != want:
        raise ValueError(f"{where}: unknown keys {sorted(got - want)}, "
                         f"missing keys {sorted(want - got)}")


def params_from_arrays(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The port's ``Transformer`` state dict (CPU tensors, for
    ``load_state_dict``) from the reference's parameter pytree as nested
    dicts of numpy arrays, with stacked ``[L, ...]`` block leaves (e.g.
    ``jax.tree.map(np.asarray, repro.launch.adapters.init_fn(key, cfg))``).
    Families ``dense`` and ``moe``. An unknown or missing key, or a leaf
    whose leading dim is not ``cfg.num_layers``, raises ``ValueError``."""
    attn = ["wq", "wk", "wv", "wo"]
    if cfg.qkv_bias:
        attn += ["bq", "bk", "bv"]
    mlp = (["router", "experts_gate", "experts_up", "experts_down"]
           if cfg.num_experts > 0 else ["w_gate", "w_up", "w_down"])
    top = ["embed", "blocks", "final_norm"]
    if not cfg.tie_embeddings:
        top.append("lm_head")
    _expect(tree, top, "params")
    blocks = tree["blocks"]
    _expect(blocks, ["attn", "mlp", "norm1", "norm2"], "params['blocks']")
    _expect(blocks["attn"], attn, "params['blocks']['attn']")
    _expect(blocks["mlp"], mlp, "params['blocks']['mlp']")
    stacked = {f"attn.{k}": blocks["attn"][k] for k in attn}
    stacked.update({f"mlp.{k}": blocks["mlp"][k] for k in mlp})
    stacked.update(norm1=blocks["norm1"], norm2=blocks["norm2"])
    state = {name: _tensor(tree[name]) for name in top if name != "blocks"}
    for name, leaf in stacked.items():
        leaf = _tensor(leaf)
        if leaf.dim() == 0 or leaf.shape[0] != cfg.num_layers:
            raise ValueError(f"params['blocks'] {name}: leading dim "
                             f"{tuple(leaf.shape)[:1]} is not num_layers="
                             f"{cfg.num_layers}")
        for i in range(cfg.num_layers):
            state[f"blocks.{i}.{name}"] = leaf[i]
    return state
