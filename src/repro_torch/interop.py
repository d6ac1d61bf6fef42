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


def _attn(prefix: str = "", bias: bool = False):
    names = ["wq", "wk", "wv", "wo"] + (["bq", "bk", "bv"] if bias else [])
    return {prefix + n: None for n in names}


def _leaves(*names: str):
    return {n: None for n in names}


_LN = {"scale": None, "bias": None}
_SSM_BLOCK = _leaves("norm", "in_proj", "conv_w", "conv_b", "A_log",
                     "D_skip", "dt_bias", "gate_norm", "out_proj")


def _skeleton(cfg):
    """``(tree, stacked)``: the reference's parameter pytree for ``cfg`` as
    nested dicts with ``None`` leaves, and the stacked leading dims of each
    top-level key whose leaves stack blocks (with the config fields that
    give them, for messages)."""
    family = cfg.family
    if family in ("dense", "moe", "vlm"):
        mlp = (_leaves("router", "experts_gate", "experts_up",
                       "experts_down")
               if cfg.num_experts > 0 else _leaves("w_gate", "w_up",
                                                   "w_down"))
        tree = {"embed": None, "final_norm": None,
                "blocks": {"attn": _attn(bias=cfg.qkv_bias), "mlp": mlp,
                           "norm1": None, "norm2": None}}
        stacked = {"blocks": ((cfg.num_layers,), "num_layers")}
    elif family == "ssm":
        tree = {"embed": None, "final_norm": None, "blocks": _SSM_BLOCK}
        stacked = {"blocks": ((cfg.num_layers,), "num_layers")}
    elif family == "hybrid":
        tree = {"embed": None, "final_norm": None, "lm_head": None,
                "ssm_blocks": _SSM_BLOCK,
                "shared": {"attn": _attn(),
                           "mlp": _leaves("w_gate", "w_up", "w_down"),
                           "norm1": None, "norm2": None}}
        period = cfg.shared_attn_period
        stacked = {"ssm_blocks": ((cfg.num_layers // period, period),
                                  "(num_layers // shared_attn_period, "
                                  "shared_attn_period)")}
    elif family == "audio":
        mlp = _leaves("w_gate", "w_down")
        tree = {"embed": None, "pos_embed": None, "enc_ln": _LN,
                "dec_ln": _LN,
                "enc_blocks": {"attn": _attn(), "mlp": mlp, "ln1": _LN,
                               "ln2": _LN},
                "dec_blocks": {"self_attn": _attn(),
                               "cross_attn": _attn("cross_"), "mlp": mlp,
                               "ln1": _LN, "ln2": _LN, "ln3": _LN}}
        stacked = {"enc_blocks": ((cfg.encoder_layers,), "encoder_layers"),
                   "dec_blocks": ((cfg.num_layers,), "num_layers")}
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    if family in ("dense", "moe", "vlm", "ssm") and not cfg.tie_embeddings:
        tree["lm_head"] = None
    return tree, stacked


def _paths(tree, prefix=()):
    """The path of every leaf of a skeleton, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


def _port_key(path, index=()) -> str:
    """The port's state-dict key of leaf ``path`` (at ``index`` of its
    top-level key's stack)."""
    return ".".join((path[0],) + tuple(map(str, index)) + path[1:])


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
    leaves stacked ``[L, ...]``, hybrid's ``[n_apps, period, ...]``, bf16
    as :class:`BF16Bits`) from a state dict of the port's model keys, on
    any device: the model's parameters, or an AdamW moment keyed like them.
    The inverse of :func:`params_from_arrays`. A missing or unknown key
    raises ``ValueError``.

    ``placeholders=True`` copies nothing: each leaf is an array of the
    right shape and dtype that holds no memory (what
    ``Checkpointer.restore`` reads from its like trees)."""
    skel, stacked = _skeleton(cfg)
    want = []
    for path in _paths(skel):
        dims = stacked.get(path[0], ((), ""))[0]
        want += [_port_key(path, i) for i in np.ndindex(*dims)]
    _expect(state, want, "state dict")

    tree: Dict[str, Any] = {}
    for path in _paths(skel):
        dims = stacked.get(path[0], ((), ""))[0]
        parts = [state[_port_key(path, i)] for i in np.ndindex(*dims)]
        shape = tuple(dims) + tuple(parts[0].shape)
        if placeholders:
            leaf = _placeholder(shape, parts[0].dtype)
        elif dims:
            leaf = _array(torch.stack(parts).reshape(shape))
        else:
            leaf = _array(parts[0])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _expect(tree: Mapping[str, Any], keys, where: str) -> None:
    got, want = set(tree), set(keys)
    if got != want:
        raise ValueError(f"{where}: unknown keys {sorted(got - want)}, "
                         f"missing keys {sorted(want - got)}")


def _expect_tree(tree: Mapping[str, Any], skel, where: str) -> None:
    """The nested dicts of ``tree`` have exactly ``skel``'s keys."""
    _expect(tree, skel, where)
    for k, sub in skel.items():
        if isinstance(sub, dict):
            if not isinstance(tree[k], Mapping):
                raise ValueError(f"{where}['{k}'] is a leaf, not a subtree")
            _expect_tree(tree[k], sub, f"{where}['{k}']")


def params_from_arrays(tree: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The port's state dict (CPU tensors, for ``load_state_dict``) from the
    reference's parameter pytree as nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, repro.launch.adapters.init_fn(key, cfg))``),
    for every family. An unknown or missing key, or a stacked leaf whose
    leading dims are not its stack's (``num_layers``, ``encoder_layers``,
    hybrid's ``(n_apps, period)``), raises ``ValueError``."""
    skel, stacked = _skeleton(cfg)
    _expect_tree(tree, skel, "params")
    state: Dict[str, torch.Tensor] = {}
    for path in _paths(skel):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        leaf = _tensor(leaf)
        dims, names = stacked.get(path[0], ((), ""))
        if tuple(leaf.shape[:len(dims)]) != dims:
            where = "".join(f"['{k}']" for k in path)
            raise ValueError(f"params{where}: leading dims "
                             f"{tuple(leaf.shape)[:len(dims)]} are not "
                             f"{names}={tuple(dims)}")
        for i in np.ndindex(*dims):
            state[_port_key(path, i)] = leaf[i] if dims else leaf
    return state
