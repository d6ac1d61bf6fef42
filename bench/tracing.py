"""The traced run: ``torch.profiler`` over the window, and the reduction of
its Chrome trace to the record that ``metrics/`` readers take.

The harness marks the window and each call with ``record_function``
spans (:data:`WINDOW`, :data:`CALL`). The record holds, in µs on the
trace's clock:

* ``window``: ``[start, end]`` of the window span;
* ``calls``: ``[[start, end], ...]`` of the call spans;
* ``device``: every kernel, copy and memset on the card inside the window,
  ``{"name", "cat", "ts", "dur"}``, clipped to the window;
* ``host``: the host's operations and runtime calls inside the window,
  the same fields, for the idle gaps' attribution.

``busy_us`` is the union of the device's intervals; the gaps between them
are the device's idle time. ``call_extents_us`` is each call's time on the
card, from its first device operation to its last.
"""
from __future__ import annotations

import bisect
import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

WINDOW = "bench.window"
CALL = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
#: gaps attributed one by one; the rest are summed as one entry
ATTRIBUTED_GAPS = 500
#: the longest traced window, s: the per-layer metrics are means a call,
#: which some tens of calls give, and the profiler's own processing after
#: the window grows with the events it holds (about 1 s a traced second)
MAX_TRACED_SECONDS = 10.0


def profiler():
    """A profiler of the host and the card, without shapes or stacks."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def load_events(path: Path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _spans(events, name) -> List[Tuple[float, float]]:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in events
                  if e.get("name") == name and e.get("cat") not in DEVICE_CATS
                  and e.get("cat") != "gpu_user_annotation")


def reduce(events: List[dict]) -> dict:
    """The record of a Chrome trace's events (see the module doc). Raises
    ``ValueError`` if the trace has no window span."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    windows = _spans(xs, WINDOW)
    if not windows:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    w0, w1 = windows[0]
    calls = [c for c in _spans(xs, CALL) if c[0] >= w0 and c[1] <= w1]

    def clipped(e):
        ts, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        ts, end = max(ts, w0), min(end, w1)
        if end <= ts:
            return None
        return {"name": e["name"], "cat": e["cat"], "ts": ts, "dur": end - ts}

    device = [c for c in (clipped(e) for e in xs
                          if e.get("cat") in DEVICE_CATS) if c]
    host = [c for c in (clipped(e) for e in xs
                        if e.get("cat") in HOST_CATS
                        and e.get("name") not in (WINDOW, CALL)) if c]
    return {"window": [w0, w1], "calls": [list(c) for c in calls],
            "device": device, "host": host}


def busy_intervals(record: dict) -> List[Tuple[float, float]]:
    """The union of the device's intervals, merged and sorted."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in record["device"])
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(x) for x in merged]


def busy_us(record: dict) -> float:
    return sum(e - s for s, e in busy_intervals(record))


def window_us(record: dict) -> float:
    w0, w1 = record["window"]
    return w1 - w0


def idle_gaps(record: dict) -> List[Tuple[float, float]]:
    """The window's stretches with nothing on the card."""
    w0, w1 = record["window"]
    gaps, t = [], w0
    for s, e in busy_intervals(record):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def short_name(name: str, limit: int = 96) -> str:
    """A device operation's name without its parameter list."""
    name = re.sub(r"^void\s+", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:  # cut at the first '(' outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out).strip()[:limit]


def call_extents_us(record: dict) -> List[float]:
    """Each traced call's extent on the card: from the start of the first
    device operation that begins inside the call's span to the end of the
    last one. A call ends in a synchronize, so its operations lie inside
    its span; a call with none gives nothing."""
    ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in record["device"])
    starts = [s for s, _ in ops]
    extents = []
    for c0, c1 in record["calls"]:
        lo, hi = bisect.bisect_left(starts, c0), bisect.bisect_left(starts, c1)
        if hi > lo:
            extents.append(max(e for _, e in ops[lo:hi]) - ops[lo][0])
    return extents


def kernel_us(record: dict, pattern: "re.Pattern") -> float:
    """Device time of the kernels whose names match ``pattern``."""
    return sum(e["dur"] for e in record["device"]
               if e["cat"] == "kernel" and pattern.search(e["name"]))


def breakdown(record: dict) -> Dict[str, list]:
    """The ten device operations that took most time and the ten largest
    sums of idle time by what the host was doing, each ``[name, s]``."""
    ops: Dict[str, float] = {}
    for e in record["device"]:
        key = short_name(e["name"])
        ops[key] = ops.get(key, 0.0) + e["dur"]
    gaps = sorted(idle_gaps(record), key=lambda g: g[0] - g[1])
    host = sorted(record["host"], key=lambda e: e["ts"])
    by_host: Dict[str, float] = {}
    if gaps:
        import numpy as np

        starts = np.array([e["ts"] for e in host], dtype=np.float64)
        ends = starts + np.array([e["dur"] for e in host], dtype=np.float64)
        durs = ends - starts
        calls = record["calls"]
        for g0, g1 in gaps[:ATTRIBUTED_GAPS]:
            mid = 0.5 * (g0 + g1)
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            if inside.size:  # the innermost host event at the gap
                name = host[int(inside[np.argmin(durs[inside])])]["name"]
            elif any(c0 <= mid <= c1 for c0, c1 in calls):
                name = "host, no traced operation (in a call)"
            else:
                name = "host, between calls"
            by_host[name] = by_host.get(name, 0.0) + (g1 - g0)
        rest = sum(g1 - g0 for g0, g1 in gaps[ATTRIBUTED_GAPS:])
        if rest:
            by_host["shorter gaps, not attributed"] = rest

    def top(d):
        return [[k, v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(by_host)}
