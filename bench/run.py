"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``workloads`` in
``BENCHMARK.json``. Needs a CUDA card: without one, or with fewer cards than
the cell asks for, it exits 2 and prints no result. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``: each number compared with its limit); the last lines of
standard error are those numbers again. ``--trace 1`` writes the
profiler's trace to ``bench/out/<cell>.trace.json``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every cache the program or torch may write stays in the checkout, at
    # fixed paths (the port builds its kernels into build/repro_torch/)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} cards; "
                    f"{torch.cuda.device_count()} found")
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  T_START)
    except Exception:
        harness.log(traceback.format_exc())
        return 1
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded in this process: {', '.join(found)}; the "
                    "benchmark runs the port without JAX or its package")
        return 3
    for name, c in result["check"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
