"""One run of one cell: set-up, the window, the check, the result line.

:func:`run_cell` does everything but the look for a card, which
``run.py`` makes first; tests call it on the CPU at a small size, with the
program's plain versions and, for the faults, a broken entry point.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from bench import tracing
from bench.generators import generate

ROOT = Path(__file__).resolve().parents[1]
#: modules that may not be loaded in the process that prints a result,
#: by whole top-level name (the port's name begins with the last one's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: outputs kept for the check, besides the last call's, as a share of the
#: calls the first timed call's length lets one expect in the window
SAMPLED_CALLS = 3


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, its traffic mix
    and the metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT, config: Optional[dict] = None,
              traffic: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; ``config`` and
    ``traffic`` update what the cell's files hold (the tests' small
    sizes)."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = {**load_json(root / conf["file"]), **(config or {})}
    mix = {**load_json(root / "bench" / "traffic" / f"{w['traffic']}.json"),
           **(traffic or {})}
    return Cell(name, int(w["chips"]), cfg, mix,
                _for_cell(spec["end_to_end"], name),
                _for_cell(spec["per_layer"], name))


def _reader(package: str, name: str) -> Callable:
    """``read`` of ``bench/<package>/<name>.py``, loaded from its file (a
    metric's name may hold a dot, which a module's may not)."""
    path = ROOT / "bench" / package / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.{package}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def forbidden_modules() -> List[str]:
    """Top-level names of :data:`FORBIDDEN` modules loaded now."""
    top = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             trace_path: Optional[Path] = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's dict.
    ``t_start`` is the process's start on ``time.perf_counter``'s clock."""
    device = torch.device(device)
    sync = _sync(device)
    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":  # the card's context, apart from the graph
        torch.zeros(1, device=device)
        sync()
        marks.append(("context", time.perf_counter()))
    graph = generate(cell.config, seed, device)
    sync()
    marks.append(("graph", time.perf_counter()))
    adapter = importlib.import_module(
        f"bench.adapters.{cell.traffic['adapter']}")
    prep = adapter.prepare(graph, cell.traffic, device)
    marks.append(("prepare", time.perf_counter()))
    out = prep.call()  # one warm call: loads (or builds) the kernels
    sync()
    del out
    marks.append(("warm call", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts = [(name, t - t_prev) for (name, t), t_prev in
             zip(marks, [t_start] + [t for _, t in marks[:-1]])]
    log(f"set-up {setup_s:.3f} s (" + ", ".join(
        f"{k} {v:.3f} s" for k, v in parts + list(prep.setup.items()))
        + ")")

    if trace:
        seconds = min(seconds, tracing.MAX_TRACED_SECONDS)
    # outputs kept for the check: a seeded sample, and the last call's; the
    # first timed call's length sets the sample's share (a warm call that
    # built the kernels would not)
    rng = random.Random(seed)
    kept: Dict[int, tuple] = {}
    share = []

    def keep(i, out, latency_s):
        if not share:
            share.append(min(1.0, SAMPLED_CALLS * latency_s
                             / max(seconds, 1e-3)))
        if rng.random() < share[0]:
            kept[i] = tuple(t.to("cpu") for t in out)

    cuda = device.type == "cuda"
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    loop = importlib.import_module(
        f"bench.loops.{cell.traffic['loop']}")
    span = None
    prof = None
    if trace:
        from torch.profiler import record_function

        span = lambda: record_function(tracing.CALL)  # noqa: E731
        prof = tracing.profiler()
        prof.__enter__()
        window_span = record_function(tracing.WINDOW)
        window_span.__enter__()
    try:
        win = loop.run(prep.call, seconds, keep, sync, span)
    finally:
        if trace:
            window_span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
    last = win.pop("last")
    if last is not None and win["calls"] - 1 not in kept:
        kept[win["calls"] - 1] = tuple(t.to("cpu") for t in last)
    del last
    for err in win["errors"]:
        log(err)
    lat = sorted(win["latencies_s"])
    log("call ms: first " + ", ".join(f"{x * 1e3:.3f}" for x in
                                       win["latencies_s"][:3])
        + f"; median {lat[len(lat) // 2] * 1e3:.3f}, max {lat[-1] * 1e3:.3f}")
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    memory_peak = max(setup_peak, window_peak) if cuda else 0
    log(f"window {win['window_s']:.3f} s, {win['calls']} calls, "
        f"{win['failed']} failed, peak {window_peak} B")

    # the check, once the program's state is freed
    work, setup_parts = prep.work, prep.setup
    prep.release()
    del prep
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = importlib.import_module(f"bench.reference.{cell.traffic['check']}")
    # nothing kept means every call failed: ``failed`` says so
    numbers = {k: 0 for k in ref.LIMITS}
    for i in sorted(kept):
        mask, state = kept[i]
        got = ref.check(graph.u, graph.v, graph.n, mask, state)
        for k, v in got.items():
            numbers[k] = max(numbers[k], v)
    log(f"checked {len(kept)} of {win['calls']} calls: {sorted(kept)}")
    correct = (win["failed"] == 0 and bool(kept)
               and all(numbers[k] <= lim for k, lim in ref.LIMITS.items()))

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    breakdown = None
    if trace:
        path = trace_path or ROOT / "bench" / "out" / f"{cell.name}.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        record = tracing.reduce(tracing.load_events(path))
        record.update(work=work, setup=setup_parts)
        for m in cell.per_layer:
            value = _reader("metrics", m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tracing.busy_us(record) * 1e-6
        device_info["window_s"] = tracing.window_us(record) * 1e-6
        breakdown = tracing.breakdown(record)
        log(f"trace {path}: {len(record['device'])} device operations, "
            f"{len(record['calls'])} calls")
    else:
        window = dict(win, edges_per_call=graph.m, peak_bytes=window_peak,
                      setup_s=setup_s)
        for m in cell.end_to_end:
            value = _reader("end_to_end", m["name"])(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": correct, "attempted": win["calls"],
              "failed": win["failed"], "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k], "limit": lim}
                       for k, lim in ref.LIMITS.items()}
    return result
