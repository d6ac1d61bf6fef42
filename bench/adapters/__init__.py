"""The program's entry points, one module each. A traffic mix names its
adapter by ``"adapter"``; the module of that name here has
``prepare(graph, traffic, device) -> Prepared``.

An adapter imports the port (``repro_torch``) inside ``prepare`` and
calls its entry point through the entry point's module, so that a test can
put a broken entry in its place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch


@dataclasses.dataclass
class Prepared:
    """What set-up hands to the window.

    ``call()`` runs the entry point once and returns ``(mask, state)`` on
    the device, without waiting for it; ``edges`` is the edges one call
    decides; ``work`` the problem's work of the call and of each tier,
    ``{"call": {"edges", "vertices"}, "<tier>": {...}}``, for the
    rooflines; ``setup`` the seconds of named set-up steps."""

    call: Callable[[], Tuple[torch.Tensor, torch.Tensor]]
    edges: int
    work: Dict[str, Dict[str, int]]
    setup: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: the program's state that ``release`` drops before the check
    held: Dict[str, object] = dataclasses.field(default_factory=dict)

    def release(self) -> None:
        self.held.clear()
        self.call = None


def valid_edges(u: torch.Tensor, v: torch.Tensor, n: int) -> int:
    """Edges a matcher has to decide: not a self-loop, both ids in range."""
    ok = (u != v) & (u >= 0) & (v >= 0) & (u < n) & (v < n)
    return int(ok.sum())
