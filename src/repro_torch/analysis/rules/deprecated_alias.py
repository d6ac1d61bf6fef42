"""Rule: deprecated-alias — the port's own code must not touch deprecated
names (port of ``repro.analysis.rules.deprecated_alias``).

``DistStats.gathered_ints`` became ``gathered_bytes`` when the state
assembly went over the wire at the spec's width; the old name survives as
a property that warns external callers with a ``DeprecationWarning``.
Library code reaching for the alias would warn from inside the library
and keep the dead name looking alive. The definition site
(``core/distributed.py``) and the tests that pin the deprecation are
exempt.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules.base import SourceFile, SourceRule

DEPRECATED_ATTRS = {
    "gathered_ints": "DistStats.gathered_bytes (spec-typed payload)",
}
_EXEMPT_SUFFIX = ("core/distributed.py",)
_EXEMPT_PARTS = ("tests/",)


class DeprecatedAlias(SourceRule):
    name = "deprecated-alias"

    def check_file(self, src: SourceFile) -> List[Finding]:
        path = src.path.replace("\\", "/")
        if src.tree is None:
            return []
        if any(path.endswith(s) for s in _EXEMPT_SUFFIX):
            return []
        if any(p in path for p in _EXEMPT_PARTS):
            return []
        findings: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Attribute):
                continue
            if node.attr not in DEPRECATED_ATTRS:
                continue
            if self.waived(src, node.lineno):
                continue
            findings.append(self.finding(
                Severity.ERROR, src.path,
                f"deprecated alias `.{node.attr}` — use "
                f"{DEPRECATED_ATTRS[node.attr]}; the alias exists only so "
                f"external callers get a DeprecationWarning",
                lineno=node.lineno,
            ))
        return findings
