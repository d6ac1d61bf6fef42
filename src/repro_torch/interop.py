"""Carry the reference's inputs across into the port.

The JAX package's ``WindowSchedule``, ``EdgeList`` and ``StateSpec`` reach
the port as plain numpy arrays and names (e.g. ``dataclasses.asdict`` of a
reference schedule), so the port's kernels can run on the reference's exact
schedule independently of the port's own ``build_window_schedule``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

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
                value = value.item()
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
