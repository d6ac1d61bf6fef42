"""``repro_torch.core.skipper.skipper`` on an edge list already on the
card: the paper's single pass with no preprocessing.

Each call lays the stream out as tiles and runs the global-tier kernel
over one state row of ``n`` cells.
"""
from __future__ import annotations

import importlib

import torch

from bench.adapters import Prepared, valid_edges
from bench.generators import Graph


def prepare(graph: Graph, traffic: dict, device: torch.device) -> Prepared:
    from repro_torch.core.statespec import StateSpec
    from repro_torch.graphs.types import EdgeList

    # the module, not the package's function of the same name
    entry = importlib.import_module("repro_torch.core.skipper")
    call_args = dict(traffic["call"])
    spec = getattr(StateSpec, call_args.pop("spec"))()
    edges = EdgeList(graph.u, graph.v, graph.n).to(device)

    def call():
        res, _ = entry.skipper(edges, spec=spec, device=device, **call_args)
        return res.match_mask, res.state

    valid = valid_edges(graph.u, graph.v, graph.n)
    work = {"call": {"edges": graph.m, "vertices": graph.n},
            "global_tier": {"edges": valid, "vertices": graph.n}}
    return Prepared(call=call, edges=graph.m, work=work,
                    held={"edges": edges})
