"""Analyzer driver: sources + built kernels + entry points + mutation
canaries (port of ``repro.analysis.runner``, with its signatures).

``run_analysis`` is the everything entry point (``python -m
repro_torch.analysis`` is a thin CLI over it): the source rules over the
given roots, then the kernel rules over every kernel target and the target
rules over every entry target. ``analyze_mutation`` runs the SAME battery
over one seeded mutant — the canary is "caught" iff the report carries an
ERROR from the mutant's expected rule.

Source rules run anywhere. Kernel and target rules need nvcc and a CUDA
card, and :func:`analyze_targets` raises ``RuntimeError`` without them:
nothing is skipped quietly. A target that fails to build is an ERROR
finding of rule ``build``; a rule that raises while it runs is an ERROR
finding of rule ``trace``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.analysis import mutations as _mut
from repro_torch.analysis.build import build_artifacts
from repro_torch.analysis.report import Finding, Report, Severity
from repro_torch.analysis.rules.base import (
    SourceFile,
    get_rules,
    kernel_rules,
    source_rules,
    target_rules,
)
from repro_torch.analysis.targets import EntryTarget, KernelTarget, get_targets

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules"}


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _iter_py_files(paths: List[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            for f in sorted(path.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    out.append(f)
        elif path.suffix == ".py":
            out.append(path)
    return out


def _rel(path: Path) -> str:
    try:
        return str(path.resolve().relative_to(_repo_root()))
    except ValueError:
        return str(path)


def require_toolchain() -> None:
    """Raise ``RuntimeError`` unless nvcc and a CUDA card are present."""
    nvcc = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if nvcc is None or not torch.cuda.is_available():
        raise RuntimeError(
            "the kernel and target rules need nvcc and a CUDA card "
            f"(nvcc: {nvcc or 'missing'}, CUDA: "
            f"{'yes' if torch.cuda.is_available() else 'no'}); run the "
            "source rules alone with --sources-only")


def analyze_sources(paths: List[str], rules=None) -> Report:
    """Run every source rule over the ``.py`` files under ``paths``."""
    rules = get_rules(rules)
    srules = source_rules(rules)
    report = Report(rules_run=[r.name for r in srules])
    for f in _iter_py_files(paths):
        src = SourceFile.parse(_rel(f), f.read_text())
        report.files_analyzed += 1
        for rule in srules:
            report.extend(rule.check_file(src))
    return report


def _trace_error(where: str, rule: str, exc: Exception) -> Finding:
    return Finding(rule="trace", severity=Severity.ERROR, where=where,
                   message=f"rule {rule} could not run: "
                           f"{type(exc).__name__}: {exc}")


def _analyze_kernels(kernels: List[KernelTarget], krules) -> Report:
    report = Report(rules_run=[r.name for r in krules])
    if not kernels:
        return report
    artifacts, failures = build_artifacts(kernels)
    for t in kernels:
        report.targets_analyzed.append(t.name)
        if t.name in failures:
            report.extend([Finding(rule="build", severity=Severity.ERROR,
                                   where=t.name, message=failures[t.name])])
            continue
        for rule in krules:
            try:
                report.extend(rule.check_kernel(artifacts[t.name]))
            except Exception as exc:  # a rule that cannot run IS a finding
                report.extend([_trace_error(t.name, rule.name, exc)])
    return report


def analyze_targets(names: Optional[List[str]] = None, rules=None) -> Report:
    """Build every kernel target and run the kernel rules over it, then
    run every entry target under the target rules (nvcc and a card)."""
    require_toolchain()
    rules = get_rules(rules)
    krules, trules = kernel_rules(rules), target_rules(rules)
    chosen = get_targets(names)
    report = _analyze_kernels(
        [t for t in chosen if isinstance(t, KernelTarget)], krules)
    for r in trules:
        if r.name not in report.rules_run:
            report.rules_run.append(r.name)
    for t in chosen:
        if not isinstance(t, EntryTarget):
            continue
        report.targets_analyzed.append(t.name)
        for rule in trules:
            try:
                report.extend(rule.check_target(t))
            except Exception as exc:  # a rule that cannot run IS a finding
                report.extend([_trace_error(t.name, rule.name, exc)])
    return report


def run_analysis(paths: Optional[List[str]] = None,
                 targets: Optional[List[str]] = None,
                 rules=None) -> Report:
    """Sources + targets in one report."""
    if paths is None:
        paths = [str(_repo_root() / "src" / "repro_torch")]
    report = analyze_sources(paths, rules)
    return report.merge(analyze_targets(targets, rules))


def analyze_mutation(name: str, rules=None) -> Report:
    """Run the battery over one seeded mutant (see ``mutations.py``).

    A kernel mutant is built from ``csrc/mutants.cu`` and runs under the
    kernel rules like any kernel target; the source mutant is written to a
    temp file and linted. A report without an ERROR from the mutant's
    expected rule means the analyzer LOST ITS TEETH.
    """
    if name in _mut.KERNEL_MUTATIONS:
        require_toolchain()
        return _analyze_kernels([_mut.target(name)],
                                kernel_rules(get_rules(rules)))
    if name in _mut.SOURCE_MUTATIONS:
        fd, tmp = tempfile.mkstemp(suffix=f"_{name}.py", text=True)
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(_mut.SOURCE_MUTATIONS[name])
            return analyze_sources([tmp], rules)
        finally:
            os.unlink(tmp)
    raise KeyError(
        f"unknown mutation {name!r}; known: {_mut.MUTATION_NAMES}"
    )


def caught(name: str, report: Report) -> bool:
    """True iff ``report`` carries an ERROR from mutant ``name``'s
    expected rule."""
    rule = _mut.EXPECTED_RULE[name]
    return any(f.rule == rule for f in report.errors)
