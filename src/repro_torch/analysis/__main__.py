"""Kernel conformance analyzer CLI for the port (the counterpart of
``tools/analyze.py``, with its flags and exit codes).

Builds every kernel instance of the port with nvcc and runs the rule
battery (shared-memory budget and V-independence, local memory,
registers, shared-memory barriers, tier order, kernel census) over them,
plus the source rules (host syncs, lru cache keys, state dtypes,
deprecated aliases) over the
given roots.

Usage (from the repository root)::

    PYTHONPATH=src python -m repro_torch.analysis [paths...]   # default: src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --sources-only src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --json report.json
    PYTHONPATH=src python -m repro_torch.analysis --targets boundary[uint8,uint8]
    PYTHONPATH=src python -m repro_torch.analysis --rules smem-barrier
    PYTHONPATH=src python -m repro_torch.analysis --mutation dropped_dma_wait
    PYTHONPATH=src python -m repro_torch.analysis --list

Without ``--sources-only`` it needs nvcc and a CUDA card and fails
(exit 2) without them. Exit codes: 0 clean, 1 findings at ERROR severity,
2 analyzer crash. ``--mutation`` exits 1 exactly when the mutant is caught
by its expected rule (0 means the analyzer lost its teeth, 2 that it
crashed).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel conformance analyzer for the Hopper port",
    )
    ap.add_argument("paths", nargs="*",
                    help="source roots/files to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--json", metavar="FILE",
                    help="write the JSON report here ('-' for stdout)")
    ap.add_argument("--targets", nargs="*", default=None,
                    help="analyze only these targets")
    ap.add_argument("--rules", nargs="*", default=None,
                    help="run only these rules")
    ap.add_argument("--mutation", metavar="NAME",
                    help="analyze one seeded mutant instead of the tree")
    ap.add_argument("--sources-only", "--no-trace", dest="sources_only",
                    action="store_true",
                    help="source rules only (no nvcc, no card)")
    ap.add_argument("--list", action="store_true",
                    help="list rules, targets, and mutations, then exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print INFO findings")
    args = ap.parse_args(argv)

    from repro_torch.analysis import (
        analyze_mutation, analyze_sources, run_analysis,
    )
    from repro_torch.analysis.runner import caught

    if args.list:
        from repro_torch.analysis.mutations import MUTATION_NAMES
        from repro_torch.analysis.rules import ALL_RULES
        from repro_torch.analysis.targets import target_names
        print("rules:    ", " ".join(r.name for r in ALL_RULES))
        print("targets:  ", " ".join(target_names()))
        print("mutations:", " ".join(MUTATION_NAMES))
        return 0

    paths = args.paths or [str(REPO_ROOT / "src" / "repro_torch")]
    if args.mutation:
        report = analyze_mutation(args.mutation, rules=args.rules)
    elif args.sources_only:
        report = analyze_sources(paths, rules=args.rules)
    else:
        report = run_analysis(paths=paths, targets=args.targets,
                              rules=args.rules)

    if args.json == "-":
        print(report.to_json())
    else:
        print(report.render(verbose=args.verbose))
        if args.json:
            Path(args.json).write_text(report.to_json() + "\n")
            print(f"json report -> {args.json}")

    if args.mutation:
        return 1 if caught(args.mutation, report) else 0
    return 0 if report.clean else 1


if __name__ == "__main__":
    try:
        code = main()
    except Exception as exc:  # crash != caught: the caller tells them apart
        print(f"analyzer crashed: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        code = 2
    sys.exit(code)
