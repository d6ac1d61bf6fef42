"""Findings, severities, and the JSON report the analyzer emits (port of
``repro.analysis.report``; the same classes, keys and policy).

Severity policy (what gates):

* ``ERROR``   — a violated invariant, or a rule that could not run (rule
  ``build`` or ``trace``). Any error makes the report unclean and the CLI
  exit 1. The clean tree must carry zero.
* ``WARNING`` — a hazard the rules cannot prove safe. Recorded, surfaced,
  does not gate.
* ``INFO``    — measurements worth keeping beside the roofline numbers
  (per-kernel shared memory, registers, occupancy). Never gates.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Optional


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule hit. ``where`` is a kernel/target name for kernel and
    target rules and a ``path`` for source rules (``lineno`` then set)."""

    rule: str
    severity: Severity
    where: str
    message: str
    lineno: Optional[int] = None
    data: Optional[Dict] = None  # rule-specific extras (budgets, counts)

    def render(self) -> str:
        loc = f"{self.where}:{self.lineno}" if self.lineno else self.where
        return f"[{self.severity.value}] {self.rule}: {loc}: {self.message}"

    def to_dict(self) -> Dict:
        out = {
            "rule": self.rule,
            "severity": self.severity.value,
            "where": self.where,
            "message": self.message,
        }
        if self.lineno is not None:
            out["lineno"] = self.lineno
        if self.data:
            out["data"] = self.data
        return out


@dataclasses.dataclass
class Report:
    """Aggregated findings over every rule x target/file pair that ran."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    targets_analyzed: List[str] = dataclasses.field(default_factory=list)
    files_analyzed: int = 0
    rules_run: List[str] = dataclasses.field(default_factory=list)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    def merge(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.targets_analyzed.extend(other.targets_analyzed)
        self.files_analyzed += other.files_analyzed
        for r in other.rules_run:
            if r not in self.rules_run:
                self.rules_run.append(r)
        return self

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity is Severity.ERROR]

    @property
    def clean(self) -> bool:
        return not self.errors

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def render(self, verbose: bool = False) -> str:
        lines = []
        shown = self.findings if verbose else [
            f for f in self.findings if f.severity is not Severity.INFO
        ]
        for f in shown:
            lines.append(f.render())
        n_err = len(self.errors)
        n_warn = sum(
            1 for f in self.findings if f.severity is Severity.WARNING
        )
        lines.append(
            f"analysis: {len(self.targets_analyzed)} target(s), "
            f"{self.files_analyzed} file(s), {len(self.rules_run)} rule(s) "
            f"-> {n_err} error(s), {n_warn} warning(s)"
        )
        return "\n".join(lines)

    def to_dict(self) -> Dict:
        return {
            "version": 1,
            "clean": self.clean,
            "targets_analyzed": self.targets_analyzed,
            "files_analyzed": self.files_analyzed,
            "rules_run": self.rules_run,
            "summary": self.by_rule(),
            "findings": [f.to_dict() for f in self.findings],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)
