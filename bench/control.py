"""The control of ``correct``, and the readings its limits are set from.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 [--out F]

For each seed it makes the cell's graph and entry point once and checks,
with the cell's reference, three answers for the same graph:

* ``sound``: one call of the program as the benchmark runs it (the lower
  reading of each number);
* ``greedy``: the plain greedy matcher (``reference/greedy.py``) run to
  its end, an independent answer the check has to accept;
* ``control``: that matcher cut one round short of its end, the least
  break of maximality it can make (the upper reading).

It needs the card, as ``run.py`` does; the benchmark's own runs never run
it.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device) -> dict:
    """The check's numbers of the three answers (see the module doc) for
    the graph of ``seed``."""
    import torch

    from bench.generators import generate
    from bench.reference.greedy import greedy

    graph = generate(cell.config, seed, device)
    adapter = importlib.import_module(
        f"bench.adapters.{cell.traffic['adapter']}")
    ref = importlib.import_module(f"bench.reference.{cell.traffic['check']}")
    prep = adapter.prepare(graph, cell.traffic, device)
    mask, state = prep.call()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = {"seed": seed,
           "sound": ref.check(graph.u, graph.v, graph.n, mask, state)}
    del mask, state
    prep.release()
    del prep
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mask, state, rounds = greedy(graph.u, graph.v, graph.n)
    out["greedy"] = ref.check(graph.u, graph.v, graph.n, mask, state)
    out["greedy_rounds"] = rounds
    mask, state, _ = greedy(graph.u, graph.v, graph.n, max_rounds=rounds - 1)
    out["control"] = ref.check(graph.u, graph.v, graph.n, mask, state)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the control runs on the card only")
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = readings(cell, seed, device)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = rows[0]["sound"].keys()
    summary = {"workload": args.workload, "seeds": args.seeds}
    for name in ("sound", "greedy", "control"):
        summary[name] = {k: [min(r[name][k] for r in rows),
                             max(r[name][k] for r in rows)] for k in keys}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out.parent, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
