"""``repro_torch.kernels.skipper_match.skipper_match`` on a prebuilt
schedule: the port's main path.

Set-up builds the schedule with the port's ``build_window_schedule`` on
the host (timed as ``schedule_s``); it stays host numpy, as the API holds
it, so every call copies it to the card, runs the window tier, the global
tier and the gather back to stream order and original ids.
"""
from __future__ import annotations

import importlib
import time

import torch

from bench.adapters import Prepared, valid_edges
from bench.generators import Graph


def prepare(graph: Graph, traffic: dict, device: torch.device) -> Prepared:
    from repro_torch.core.statespec import StateSpec
    from repro_torch.graphs.types import EdgeList
    from repro_torch.graphs.windows import build_window_schedule

    ops = importlib.import_module("repro_torch.kernels.skipper_match.ops")
    args = traffic["schedule"]
    call_args = dict(traffic["call"])
    spec = getattr(StateSpec, call_args.pop("spec"))()
    edges = EdgeList(graph.u, graph.v, graph.n)
    t0 = time.perf_counter()
    schedule = build_window_schedule(
        edges, args["window"], args["tile_size"], reorder=args["reorder"])
    schedule_s = time.perf_counter() - t0
    backend = None if device.type == "cuda" else "torch"

    def call():
        res = ops.skipper_match(edges, schedule=schedule, spec=spec,
                                backend=backend, device=device, **call_args)
        return res.match_mask, res.state

    window = schedule.window
    dense_vertices = sum(min(window, graph.n - int(w) * window)
                         for w in schedule.window_ids)
    valid = valid_edges(graph.u, graph.v, graph.n)
    windowed = int(schedule.num_windowed)
    work = {"call": {"edges": graph.m, "vertices": graph.n},
            "window_tier": {"edges": windowed, "vertices": dense_vertices},
            "global_tier": {"edges": valid - windowed, "vertices": graph.n}}
    return Prepared(call=call, edges=graph.m, work=work,
                    setup={"schedule_s": schedule_s},
                    held={"schedule": schedule, "edges": edges})
