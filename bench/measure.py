"""Run a cell several times, one process after another, and report the
spread of each metric: what a bound is set from.

    python3 bench/measure.py --workload <cell> --seeds 1 2 3 4 5 6 \
        [--sets 2] [--seconds 50] [--trace-seeds 7 8 9] \
        [--extra-seeds 10 11 --extra-seconds 5] [--out F.jsonl]

Each set runs ``run.py`` once for every seed of ``--seeds`` (the same seeds
in every set); ``--trace-seeds`` adds a traced run each, and
``--extra-seeds`` short runs that only add seeds to the check. The kernels
are built first, so no run of a set pays the build. Every run's result
line, exit code, time and the end of its standard error go to ``--out``
as JSON lines; the last line there, and on standard output, is the
summary: per set and metric the median and the spread, the distance
between the first and the third quartile of ``statistics.quantiles(values,
n=4)`` as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ("import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import _build; "
         "from repro_torch.kernels.skipper_match import kernel; "
         "_build.build(kernel.SOURCE)")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "bench/run.py", "--workload", workload, "--seed",
           str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"seed": seed, "seconds": seconds, "trace": trace,
            "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr_tail": proc.stderr[-3000:]}


def spread(values):
    """``(median, (q3 - q1) / median)`` of ``values``."""
    med = statistics.median(values)
    if len(values) < 2 or not med:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def summarize(runs) -> dict:
    sets = {}
    for r in runs:
        if r["trace"] or r.get("set") is None or not r["result"]:
            continue
        for name, m in r["result"]["metrics"].items():
            sets.setdefault(r["set"], {}).setdefault(name, []).append(
                m["value"])
    out = {}
    for s, metrics in sorted(sets.items()):
        out[s] = {name: dict(zip(("median", "spread"), spread(v)), n=len(v))
                  for name, v in metrics.items()}
    correct = [r["result"]["correct"] if r["result"] else None for r in runs]
    return {"sets": out, "correct": correct,
            "seeds_correct": sorted({r["seed"] for r in runs if r["result"]
                                     and r["result"]["correct"]})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=50)
    p.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    p.add_argument("--extra-seeds", type=int, nargs="*", default=[])
    p.add_argument("--extra-seconds", type=float, default=5)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sink = open(args.out, "a") if args.out else None

    def emit(row):
        short = {k: v for k, v in row.items() if k != "stderr_tail"}
        if short.get("result"):  # the metrics and the verdict, not the trace
            res = short["result"]
            short["result"] = {
                "correct": res["correct"], "attempted": res["attempted"],
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "peak": res["device"]["memory_peak_bytes"]}
        print(json.dumps(short), flush=True)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()

    subprocess.run([sys.executable, "-c", BUILD], cwd=ROOT, check=True)
    emit({"workload": args.workload, "card": card()})
    runs = []
    plan = [(s, seed, args.seconds, 0) for s in range(args.sets)
            for seed in args.seeds]
    plan += [(None, seed, args.seconds, 1) for seed in args.trace_seeds]
    plan += [(None, seed, args.extra_seconds, 0) for seed in args.extra_seeds]
    for s, seed, seconds, trace in plan:
        row = dict(one_run(args.workload, seed, seconds, trace), set=s)
        runs.append(row)
        emit(row)
    emit({"summary": summarize(runs), "card": card()})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
