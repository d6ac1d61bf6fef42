"""A model's parameters fully sharded over a mesh's ranks (FSDP, ZeRO-3):
what the reference's ``jit`` with ``param_shardings`` does implicitly.

At rest each rank holds exactly the slice of every parameter that its
spec (``sharding.module_specs``) names, and the AdamW moments are built
beside those slices. A parameter that some axis of more than one rank
splits is made whole only where the model reads it: the module attribute
becomes a parametrization (``torch.nn.utils.parametrize``) over the
rank's slice whose forward all-gathers the slice and whose backward sums
the whole gradient over the data ranks (``collectives.compressed_psum``)
and keeps the rank's slice of it, which is what a reduce-scatter leaves.
So a step holds a leaf whole while it is used: with remat, one block's
weights, gathered again when backward recomputes the block; the
gradients that reach AdamW are slices. A leaf whose spec splits over no
axis of more than one rank is left alone; its gradient is summed over
the data ranks after the backward.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.distributed as dist
from torch.nn.utils import parametrize

from repro_torch.parallel import sharding
from repro_torch.parallel.collectives import compressed_psum


class _Gather(torch.autograd.Function):
    """The rank's slice of parameter ``key`` -> the whole parameter; the
    whole gradient -> the rank's slice of its sum over the data ranks."""

    @staticmethod
    def forward(ctx, local, owner, key):
        ctx.owner, ctx.key = owner, key
        return owner.whole(key, local)

    @staticmethod
    def backward(ctx, grad):
        owner = ctx.owner
        if owner.shards is not None:
            grad = compressed_psum({"g": grad.contiguous()},
                                   owner.shards.group, owner.mode)["g"]
        # a copy, so the whole gradient is freed
        return owner.slice(ctx.key, grad).clone(
            memory_format=torch.contiguous_format), None, None


class _Whole(torch.nn.Module):
    def __init__(self, owner: "ShardedParams", key: str):
        super().__init__()
        self.owner, self.key = owner, key

    def forward(self, local):
        return _Gather.apply(local, self.owner, self.key)


class ShardedParams:
    """``model``'s parameters sharded over ``mesh`` (which has ranks);
    gradients are summed over the data ranks in bf16 when ``mode`` is
    ``"bf16"`` (``TrainConfig.grad_compression``)."""

    def __init__(self, model: torch.nn.Module, mesh: sharding.Mesh,
                 mode: str = "none"):
        if mesh.device_mesh is None:
            raise ValueError("a mesh without ranks shards nothing")
        self.mesh, self.mode = mesh, mode
        self.specs = sharding.module_specs(model, mesh)
        # AdamW's decay rule reads the state-dict keys, which the
        # parametrizations rename
        self.ndims = model.reference_ndims()
        dm = mesh.device_mesh
        self.coords = {a: dm.get_local_rank(a) for a in mesh.axis_names}
        with sharding.set_mesh(mesh):
            self.shards = sharding.data_shards()
        # the split leaves: the number of slices each is cut into
        self.split = {}
        for k, spec in self.specs.items():
            n = mesh.axis_size(tuple(a for e in spec
                                     for a in sharding.entry_axes(e)))
            if n > 1:
                self.split[k] = n
        self.shapes = {}
        owners = {}
        for k, p in model.named_parameters():
            owner, _, attr = k.rpartition(".")
            owners[k] = (model.get_submodule(owner), attr)
            self.shapes[k] = (p.shape, p.stride())
        #: this rank's parameter of each state-dict key: its slice where
        #: split (the module reads it whole), else the whole parameter
        self.params: Dict[str, torch.nn.Parameter] = {}
        for k, (mod, attr) in owners.items():
            p = getattr(mod, attr)
            if k in self.split:
                p.data = sharding.distribute(p.detach(), self.specs[k],
                                             mesh).to_local()
                parametrize.register_parametrization(
                    mod, attr, _Whole(self, k), unsafe=True)
                p = mod.parametrizations[attr].original
            self.params[k] = p

    def whole(self, key: str, local: torch.Tensor) -> torch.Tensor:
        """Parameter ``key`` made whole from each rank's slice."""
        from torch.distributed.tensor import DTensor

        shape, stride = self.shapes[key]
        return DTensor.from_local(
            local, self.mesh.device_mesh,
            sharding.placements(self.specs[key], self.mesh),
            run_check=False, shape=shape, stride=stride).full_tensor()

    def local(self) -> Dict[str, torch.Tensor]:
        """This rank's slice of every parameter."""
        return {k: p.detach() for k, p in self.params.items()}

    def slice(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor shaped like parameter
        ``key``."""
        if key not in self.split:
            return full
        return full[sharding.shard_slices(self.specs[key], full.shape,
                                          self.mesh, self.coords)]

    def reduce(self, grads: Mapping[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """``(the gradients summed over the data ranks, their global
        norm)``, from the step's gradients of :attr:`params`: the split
        leaves' are summed slices already, the others are summed here in
        place."""
        grads = dict(grads)
        whole = {k: g for k, g in grads.items() if k not in self.split}
        if self.shards is not None:
            grads.update(compressed_psum(whole, self.shards.group,
                                         self.mode))
        sq = torch.zeros((), dtype=torch.float32,
                         device=next(iter(grads.values())).device)
        if self.split:
            # over the mesh's ranks (the process group's): a slice held
            # by several ranks alike is counted once
            for k in sorted(self.split):
                sq = sq + (torch.sum(torch.square(grads[k].float()))
                           * (self.split[k] / self.mesh.size))
            dist.all_reduce(sq)
        for k in sorted(whole):
            sq = sq + torch.sum(torch.square(grads[k].float()))
        return grads, torch.sqrt(sq)

    def shard(self, tree: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """This rank's slice of each whole tensor of ``tree`` (keyed like
        the parameters), as copies where split (a view would keep the
        whole tensor's storage alive)."""
        return {k: self.slice(k, t).clone(
            memory_format=torch.contiguous_format) if k in self.split else t
            for k, t in tree.items()}

    def full(self, tree: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Each rank's slices of ``tree`` (keyed like the parameters,
        sharded like them: the parameters or a moment) made whole."""
        return {k: self.whole(k, t) if k in self.split else t
                for k, t in tree.items()}
