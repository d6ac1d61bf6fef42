"""Production and run-time meshes (port of ``repro.launch.mesh``).

One pod: 16 x 16 = 256 devices, axes ``("data", "model")``. Across pods:
2 x 16 x 16 = 512, axes ``("pod", "data", "model")``; ``"pod"`` carries
only data parallelism and ``"model"`` stays inside a pod. The production
meshes are descriptors (``parallel.sharding.Mesh``): names and sizes, no
ranks; the dry-run reckons with them.

``make_host_mesh`` is the mesh a run executes on: ``(data = world / m,
model = m)`` over the ranks of the default process group, a
``DeviceMesh`` on the card (NCCL) or the CPU (gloo), else a 1x1
descriptor. Functions, not constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

from repro_torch.parallel.sharding import Mesh, abstract_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """``(data, model)`` over the ranks of the default process group when
    one is initialised (its backend's device type: ``cuda`` for NCCL,
    else ``cpu``), else a 1x1 descriptor with no ranks."""
    import torch.distributed as dist

    ranked = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if ranked else 1
    if n % model_axis:
        raise ValueError(f"a model axis of {model_axis} does not divide "
                         f"{n} rank(s)")
    if not ranked:
        return abstract_mesh((1, 1), ("data", "model"))
    from torch.distributed.device_mesh import init_device_mesh

    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh.of(init_device_mesh(kind, (n // model_axis, model_axis),
                                    mesh_dim_names=("data", "model")))
