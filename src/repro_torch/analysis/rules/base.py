"""Rule framework: kinds, waivers, registry (port of
``repro.analysis.rules.base``).

A rule is a small stateless object with a ``name`` (the string findings
carry and waiver comments reference) and one ``check_*`` method per kind.
Source rules honor per-line waiver comments of the form ``# <name>: ok``
(e.g. ``# state-dtype: ok``, ``# host-sync: ok``) so genuine exceptions are
documented at the site they occur.

Kinds: ``source`` rules read ``.py`` files and run anywhere; ``kernel``
rules read one built kernel instance (``build.KernelArtifact``: its ptxas
report, its PTX, and a launcher for the rules that run it); ``target``
rules run an entry point on the card. Kernel and target rules need nvcc
and a card.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional

from repro_torch.analysis.report import Finding, Severity


@dataclasses.dataclass
class SourceFile:
    """Parsed source handed to SourceRules: path + text + AST (parsed once
    for the whole battery, with parent links attached)."""

    path: str            # repo-relative (or absolute for temp fixtures)
    text: str
    tree: Optional[ast.AST]
    lines: List[str]

    @classmethod
    def parse(cls, path: str, text: str) -> "SourceFile":
        try:
            tree = ast.parse(text, filename=path)
        except SyntaxError:
            tree = None
        else:
            for node in ast.walk(tree):
                for child in ast.iter_child_nodes(node):
                    child._parent = node  # type: ignore[attr-defined]
        return cls(path=path, text=text, tree=tree, lines=text.splitlines())

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class Rule:
    name: str = "rule"
    kind: str = "source"  # 'source' | 'kernel' | 'target'

    def waived(self, src: SourceFile, lineno: int) -> bool:
        return f"# {self.name}: ok" in src.line(lineno)

    def finding(self, severity: Severity, where: str, message: str,
                lineno: Optional[int] = None, data=None) -> Finding:
        return Finding(
            rule=self.name, severity=severity, where=where,
            message=message, lineno=lineno, data=data,
        )


class SourceRule(Rule):
    kind = "source"

    def check_file(self, src: SourceFile) -> List[Finding]:
        raise NotImplementedError


class KernelRule(Rule):
    kind = "kernel"

    def check_kernel(self, artifact) -> List[Finding]:
        raise NotImplementedError


class TargetRule(Rule):
    kind = "target"

    def check_target(self, target) -> List[Finding]:
        raise NotImplementedError


def _build_registry() -> List[Rule]:
    # imported here (not at module top) so base.py stays import-cycle free
    from repro_torch.analysis.rules.barrier import SmemBarrier
    from repro_torch.analysis.rules.census import KernelCensus
    from repro_torch.analysis.rules.deprecated_alias import DeprecatedAlias
    from repro_torch.analysis.rules.host_sync import HostSync, LruStaticKey
    from repro_torch.analysis.rules.order import TierOrder
    from repro_torch.analysis.rules.resources import (
        LocalMemory, Registers, SmemBudget,
    )
    from repro_torch.analysis.rules.state_dtype import StateDtype

    return [
        # kernel rules
        SmemBudget(),
        LocalMemory(),
        Registers(),
        SmemBarrier(),
        TierOrder(),
        # target rules
        KernelCensus(),
        # source rules
        StateDtype(),
        HostSync(),
        LruStaticKey(),
        DeprecatedAlias(),
    ]


ALL_RULES: List[Rule] = _build_registry()


def get_rules(names: Optional[List[str]] = None) -> List[Rule]:
    if names is None:
        return list(ALL_RULES)
    by_name = {r.name: r for r in ALL_RULES}
    missing = [n for n in names if n not in by_name]
    if missing:
        raise KeyError(
            f"unknown rule(s) {missing}; known: {sorted(by_name)}"
        )
    return [by_name[n] for n in names]


def source_rules(rules: List[Rule]) -> List[SourceRule]:
    return [r for r in rules if r.kind == "source"]


def kernel_rules(rules: List[Rule]) -> List[KernelRule]:
    return [r for r in rules if r.kind == "kernel"]


def target_rules(rules: List[Rule]) -> List[TargetRule]:
    return [r for r in rules if r.kind == "target"]
