"""Parameter and activation sharding rules: FSDP and TP, pod-aware (port
of ``repro.parallel.sharding``).

Meshes are ``("data", "model")`` on one pod or ``("pod", "data",
"model")`` across pods:

* the ``fsdp`` axes are ``("pod", "data")`` where present, else
  ``("data",)``: parameters, AdamW moments and gradients are fully sharded
  over them (ZeRO-3), on top of tensor parallelism over ``"model"``;
* the ``tp`` axis is ``"model"``: attention head projections and the FFN's
  hidden dim.

The rules are the reference's, rule for rule: regular expressions over a
leaf's path in the reference's parameter pytree (``"blocks/attn/wq"``),
so every family gets a spec without per-model plumbing. A dim is sharded
only where the axis size divides it; otherwise it is replicated.

A :class:`Mesh` names axes and their sizes and holds no devices (the
counterpart of ``compat.abstract_mesh``), so the 16x16 and 2x16x16
production meshes exist without 512 ranks. It may wrap a
``torch.distributed.device_mesh.DeviceMesh`` over real ranks; only then
does anything move (:func:`param_shardings`, :func:`distribute`,
:func:`constrain`). A :class:`Spec` is a tuple with one entry a tensor
dim: an axis name, a tuple of axis names, or ``None``; it compares equal
to ``tuple(jax.sharding.PartitionSpec(...))``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch import interop

FSDP_AXES = ("pod", "data")


class Spec(tuple):
    """A partition spec: one entry a dim (axis name, tuple of names, or
    ``None``); trailing dims not named are replicated."""

    def __new__(cls, *entries):
        # a one-axis tuple is that axis, as PartitionSpec normalises it
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, and optionally the ``DeviceMesh`` of the
    ranks that hold them (same names, same sizes)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_mesh: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}`` in mesh order, as ``jax`` meshes give it."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def axis_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (a name or a tuple)."""
        sizes = self.shape
        n = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            n *= sizes[a]
        return n

    def label(self) -> str:
        return "x".join(map(str, self.axis_sizes))

    @classmethod
    def of(cls, device_mesh) -> "Mesh":
        """The descriptor of a ``DeviceMesh`` (which it wraps)."""
        return cls(tuple(device_mesh.mesh_dim_names),
                   tuple(device_mesh.mesh.shape), device_mesh)


def abstract_mesh(shape, names) -> Mesh:
    """A device-free mesh (``compat.abstract_mesh``)."""
    return Mesh(tuple(names), tuple(int(s) for s in shape))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    fsdp: Tuple[str, ...]        # ("pod", "data") or ("data",)
    tp: str                      # "model"
    mesh: Mesh

    def axis_size(self, axes) -> int:
        return self.mesh.axis_size(axes)


def rules_for_mesh(mesh: Mesh) -> AxisRules:
    names = mesh.axis_names
    fsdp = tuple(a for a in FSDP_AXES if a in names)
    if not fsdp:
        fsdp = (names[0],)
    tp = "model" if "model" in names else names[-1]
    return AxisRules(fsdp=fsdp, tp=tp, mesh=mesh)


# (regex over the leaf's path, spec template): "F" the fsdp axes, "T" the
# tp axis, None replicated; right-aligned to the leaf's rank, so stacked
# [L, ...] leaves get leading Nones
_RULES = [
    (r"embed", ("T", "F")),                  # [V, D] vocab over tp
    (r"lm_head", ("F", "T")),                # [D, V]
    (r"(wq|wk|wv|in_proj|w_gate|w_up|dt_proj|cross_wq|enc_wq|enc_wk|enc_wv)$",
     ("F", "T")),
    (r"(wo|w_down|out_proj|cross_wo|enc_wo)$", ("T", "F")),
    (r"(bq|bk|bv|b_gate|b_up)$", ("T",)),
    (r"(bo|b_down)$", ("F",)),
    (r"router", ("F", None)),                # [D, E] experts replicated
    (r"experts_(gate|up)$", (None, "F", "T")),   # [E, D, F] TP-MoE
    (r"experts_down$", (None, "T", "F")),        # [E, F, D]
    (r"conv_w", (None, None)),               # ssm depthwise conv [W, C]
    (r"(A_log|D_skip|dt_bias|conv_b)", (None,)),
    (r"(norm|scale|bias|ln)", (None,)),
    (r"pos_embed", (None, "F")),
]


def _spec_for(path: str, shape: Tuple[int, ...], rules: AxisRules) -> Spec:
    for pat, template in _RULES:
        if re.search(pat, path):
            tpl = list(template)
            pad = len(shape) - len(tpl)
            if pad < 0:
                tpl = tpl[-len(shape):] if len(shape) else []
            else:
                tpl = [None] * pad + tpl
            spec = []
            for dim, t in zip(shape, tpl):
                if t == "F":
                    ax = rules.fsdp if len(rules.fsdp) > 1 else rules.fsdp[0]
                    spec.append(ax if dim % rules.axis_size(ax) == 0
                                else None)
                elif t == "T":
                    spec.append(rules.tp if dim % rules.axis_size(rules.tp)
                                == 0 else None)
                else:
                    spec.append(None)
            return Spec(*spec)
    return Spec()  # replicated default


def reference_tree(params) -> Mapping[str, Any]:
    """The reference's pytree (nested dicts, leaves with ``.shape``) of a
    model (its ``cfg`` and parameters, on any device, ``meta`` included:
    nothing is copied), or ``params`` itself when it is a tree already."""
    if isinstance(params, torch.nn.Module):
        return interop.arrays_from_params(dict(params.named_parameters()),
                                          params.cfg, placeholders=True)
    return params


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k in sorted(tree):
        if isinstance(tree[k], Mapping):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _map(tree, fn):
    """``fn(path string, leaf)`` over a nested dict, keeping its nesting."""
    out: Dict[str, Any] = {}
    for path, leaf in _leaves(tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn("/".join(path), leaf)
    return out


def param_specs(params, mesh: Mesh) -> Dict[str, Any]:
    """A :class:`Spec` for every leaf of the reference's parameter pytree,
    keyed as the reference keys it (``specs["blocks"]["attn"]["wq"]``),
    for a model (on ``meta`` too) or a tree of leaves with ``.shape``."""
    rules = rules_for_mesh(mesh)
    return _map(reference_tree(params),
                lambda path, leaf: _spec_for(path, tuple(leaf.shape), rules))


def leaves(tree) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` of a nested dict (the reference's path
    strings)."""
    return {"/".join(p): leaf for p, leaf in _leaves(tree)}


def module_specs(model: torch.nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """The spec of each of the model's own parameters, by state-dict key:
    its leaf's spec in the reference's pytree without the stacked leading
    dims (block ``i``'s ``attn.wq`` is ``[D, Hq*hd]``; the reference's
    leaf is ``[L, D, Hq*hd]``, spec ``(None, F, T)``: here ``(F, T)``)."""
    rules = rules_for_mesh(mesh)
    # the templates are right-aligned and no longer than a block's own
    # rank, so the stacked dims only ever take leading Nones
    return {key: _spec_for("/".join(x for x in key.split(".")
                                    if not x.isdigit()),
                           tuple(p.shape), rules)
            for key, p in model.named_parameters()}


# ------------------------------------------------------------ placements --
def entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh: Mesh):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that the entry of ``dim`` names, ``Replicate()`` on every
    other mesh dim. An entry of two axes (``("pod", "data")``) shards its
    dim over both, the first axis outermost, as in ``jax``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            if a in mesh.axis_names:
                out[mesh.axis_names.index(a)] = Shard(dim)
    return tuple(out)


def param_shardings(params, mesh: Mesh) -> Dict[str, Any]:
    """DTensor placements of every leaf (``param_specs`` turned into
    ``placements``), keyed as :func:`param_specs` keys them."""
    specs = param_specs(params, mesh)
    return _map(specs, lambda path, spec: placements(spec, mesh))


def shard_slices(spec: Spec, shape, mesh: Mesh, coords: Mapping[str, int]
                 ) -> Tuple[slice, ...]:
    """The slice of a ``shape`` array that the rank at mesh coordinates
    ``coords`` holds under ``spec`` (the reference's layout: an entry of
    several axes is split with the first axis outermost)."""
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = [a for a in entry_axes(entry) if a in mesh.axis_names]
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def distribute(t: torch.Tensor, spec: Spec, mesh: Mesh):
    """``t`` (whole, the same on every rank) as a DTensor sharded per
    ``spec`` over the mesh's ranks: each rank keeps a copy of its own
    slice (no collective; a view would keep ``t``'s storage alive)."""
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh
    coords = {a: dm.get_local_rank(a) for a in mesh.axis_names}
    local = t[shard_slices(spec, t.shape, mesh, coords)].clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, dm, placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


# --------------------------------------------------------------- context --
class _Context(NamedTuple):
    mesh: Mesh
    local_batch: bool


#: the meshes in scope, innermost last. Process-wide, not a ContextVar:
#: backward's remat recompute runs on the autograd engine's device thread
#: and must see the mesh its forward saw
_CURRENT: list = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh, local_batch: bool = False):
    """Install ``mesh`` for the block (``compat.set_mesh``).
    ``local_batch``: each data rank holds its own rows of the batch (the
    training step); otherwise every rank holds the whole input (serving),
    as a replicated ``jax`` array would be."""
    _CURRENT.append(_Context(mesh, local_batch))
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> Optional[Mesh]:
    """The mesh in scope, or ``None`` (``compat.get_abstract_mesh``)."""
    return _CURRENT[-1].mesh if _CURRENT else None


class DataShards(NamedTuple):
    """The data axes of the mesh in scope, seen from this rank."""
    count: int          # data shards (ranks along the fsdp axes)
    index: int          # this rank's shard
    group: Any          # the process group along them
    local_batch: bool   # each shard holds its own rows


def data_shards() -> Optional[DataShards]:
    """The data shards of the mesh in scope when it has ranks and more
    than one shard along its fsdp axes; ``None`` otherwise (the
    reference's ``moe._mesh_data_axes`` finding no mesh)."""
    if not _CURRENT:
        return None
    mesh, local = _CURRENT[-1]
    axes = tuple(a for a in FSDP_AXES if a in mesh.axis_names)
    if not axes or mesh.axis_size(axes) <= 1 or mesh.device_mesh is None:
        return None
    if len(axes) > 1:
        raise NotImplementedError(
            f"ranks along {axes}: a run's mesh has one data axis "
            "(launch.mesh.make_host_mesh)")
    dm = mesh.device_mesh
    return DataShards(mesh.axis_size(axes), dm.get_local_rank(axes[0]),
                      dm.get_group(axes[0]), local)


def constrain(x, spec: Optional[Spec]):
    """Lay ``x`` out as ``spec`` says on the mesh in scope. A no-op without
    a mesh or for a plain tensor (the port's activations are each rank's
    own tensors; the batch split is :func:`batch_spec`'s); a DTensor is
    redistributed, after the entries of axes the mesh lacks are
    dropped."""
    mesh = current_mesh()
    if spec is None or mesh is None or mesh.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    kept = []
    for entry in tuple(spec) + (None,) * (x.dim() - len(spec)):
        axes = tuple(a for a in entry_axes(entry) if a in mesh.axis_names)
        kept.append(None if not axes else
                    (axes if isinstance(entry, tuple) else axes[0]))
    return x.redistribute(mesh.device_mesh, placements(Spec(*kept), mesh))


def batch_spec(mesh_names: Tuple[str, ...]) -> Spec:
    fsdp = tuple(a for a in FSDP_AXES if a in mesh_names)
    return Spec(fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None))
