"""Carry the reference's inputs across into the port.

The JAX package's ``WindowSchedule``, ``EdgeList`` and ``StateSpec`` reach
the port as plain numpy arrays and names (e.g. ``dataclasses.asdict`` of a
reference schedule), so the port's kernels can run on the reference's exact
schedule independently of the port's own ``build_window_schedule``. A
model's parameters reach it as the reference's pytree of numpy arrays
(``params_from_arrays``) and leave it in the same form
(``arrays_from_params``), which is what checkpoints store. numpy has no
bfloat16, so a bf16 leaf is a :class:`BF16Bits` array of its bit patterns.
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


class BF16Bits(np.ndarray):
    """A uint16 array holding bfloat16 bit patterns: a bf16 leaf of a
    pytree of numpy arrays (numpy has no bfloat16). Make one with
    :func:`bf16_bits`; :func:`torch_from_bits` reads it back."""


def bf16_bits(bits) -> BF16Bits:
    return np.asarray(bits, dtype=np.uint16).view(BF16Bits)


def bits_of(t: torch.Tensor) -> BF16Bits:
    """The bit patterns of a bf16 tensor (copied to the host)."""
    # a copy to the host is what this function is for
    u16 = t.detach().contiguous().view(torch.int16)
    u16 = u16.cpu().numpy()  # host-sync: ok
    return bf16_bits(u16.view(np.uint16))


def torch_from_bits(bits) -> torch.Tensor:
    """A CPU bf16 tensor from bfloat16 bit patterns (uint16)."""
    u16 = np.ascontiguousarray(np.asarray(bits).view(np.uint16))
    return torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16)


def _tensor(a) -> torch.Tensor:
    if isinstance(a, BF16Bits):
        return torch_from_bits(a)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16; f32 holds it exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _array(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return bits_of(t)
    # a copy to the host is what this function is for
    return t.detach().cpu().numpy()  # host-sync: ok


def _names(cfg):
    """(attention leaves, MLP leaves, top-level keys) of the reference's
    parameter pytree for ``cfg``."""
    attn = ["wq", "wk", "wv", "wo"]
    if cfg.qkv_bias:
        attn += ["bq", "bk", "bv"]
    mlp = (["router", "experts_gate", "experts_up", "experts_down"]
           if cfg.num_experts > 0 else ["w_gate", "w_up", "w_down"])
    top = ["embed", "blocks", "final_norm"]
    if not cfg.tie_embeddings:
        top.append("lm_head")
    return attn, mlp, top


def _placeholder(shape, dtype: torch.dtype) -> np.ndarray:
    """A read-only array of ``shape`` that holds no memory of its own."""
    if dtype == torch.bfloat16:
        return np.broadcast_to(np.zeros((), np.uint16), shape).view(BF16Bits)
    zero = torch.zeros((), dtype=dtype)
    zero = zero.numpy()  # host-sync: ok — a CPU tensor
    return np.broadcast_to(zero, shape)


def arrays_from_params(state: Mapping[str, torch.Tensor], cfg,
                       placeholders: bool = False) -> Dict[str, Any]:
    """The reference's parameter pytree (nested dicts of numpy arrays, block
    leaves stacked ``[L, ...]``, bf16 as :class:`BF16Bits`) from a state
    dict of the port's ``Transformer`` keys, on any device: the model's
    parameters, or an AdamW moment keyed like them. The inverse of
    :func:`params_from_arrays`. A missing or unknown key raises
    ``ValueError``.

    ``placeholders=True`` copies nothing: each leaf is an array of the
    right shape and dtype that holds no memory (what
    ``Checkpointer.restore`` reads from its like trees)."""
    attn, mlp, top = _names(cfg)
    block_keys = ([f"attn.{k}" for k in attn] + [f"mlp.{k}" for k in mlp]
                  + ["norm1", "norm2"])
    want = [k for k in top if k != "blocks"] + [
        f"blocks.{i}.{k}" for i in range(cfg.num_layers) for k in block_keys]
    _expect(state, want, "state dict")

    def stacked_leaf(k):
        layers = [state[f"blocks.{i}.{k}"] for i in range(cfg.num_layers)]
        if placeholders:
            return _placeholder((len(layers),) + tuple(layers[0].shape),
                                layers[0].dtype)
        return _array(torch.stack(layers))

    def leaf(t):
        return (_placeholder(tuple(t.shape), t.dtype) if placeholders
                else _array(t))

    tree: Dict[str, Any] = {k: leaf(state[k]) for k in top if k != "blocks"}
    stacked = {k: stacked_leaf(k) for k in block_keys}
    tree["blocks"] = {
        "attn": {k: stacked[f"attn.{k}"] for k in attn},
        "mlp": {k: stacked[f"mlp.{k}"] for k in mlp},
        "norm1": stacked["norm1"], "norm2": stacked["norm2"],
    }
    return tree


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
    attn, mlp, top = _names(cfg)
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
