"""Rule: state-dtype — no hardcoded vertex-state dtypes outside statespec
(port of ``repro.analysis.rules.state_dtype``, for torch).

``core/statespec.StateSpec`` is the single source of truth for how wide
vertex state is at rest, in the kernels and in counters; a literal
``torch.int32`` / ``torch.uint8`` (or ``np.int32`` / ``np.uint8``) on a
state-array allocation anywhere else silently pins one tier back to a
fixed width.

A violation is an allocator call — ``torch.zeros``/``ones``/``full``/
``empty``/``*_like``, ``new_zeros``/``new_ones``/``new_full``/
``new_empty``, ``.to(dtype)`` or ``.type(dtype)`` — whose dtype argument
is a literal int32/uint8 AND whose context names a state-ish value
(assignment target, or the receiver of ``.to``/``.type``, matches the
reference's ``STATEISH`` names: ``state* / rebuilt / flat / used_*``).
Waive a genuine fixed-width site with ``# state-dtype: ok`` on the same
line; ``repro_torch/core/statespec.py`` itself is exempt (it DEFINES the
widths).
"""
from __future__ import annotations

import ast
import re
from typing import List

from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules.base import SourceFile, SourceRule

DTYPE_LITERALS = {"int32", "uint8"}
DTYPE_MODULES = {"torch", "np", "numpy"}
ALLOCATORS = {
    "zeros", "ones", "full", "empty",
    "zeros_like", "ones_like", "full_like", "empty_like",
    "new_zeros", "new_ones", "new_full", "new_empty", "to", "type",
}
#: methods whose receiver is the value being re-typed
_CASTS = {"to", "type"}
# The reference's names for vertex state (or its aliases through the
# pipelines): the committed state array, the mask-rebuilt state, the
# flattened renumbered state (the bare name ``flat``), and the capacitated
# per-side used counts.
STATEISH = re.compile(
    r"(?:^|_)(?:state|states|rebuilt|used)(?:$|_|[0-9])|^flat[0-9]*$"
)
_EXEMPT_SUFFIX = ("repro_torch/core/statespec.py",)


def _names_in(node: ast.AST):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr
        elif isinstance(sub, ast.arg):
            yield sub.arg


def _is_dtype_literal(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr in DTYPE_LITERALS
        and isinstance(node.value, ast.Name)
        and node.value.id in DTYPE_MODULES
    )


def _dtype_literal_in_call(call: ast.Call):
    for arg in call.args:
        if _is_dtype_literal(arg):
            return arg.attr
    for kw in call.keywords:
        if kw.arg == "dtype" and _is_dtype_literal(kw.value):
            return kw.value.attr
    return None


def _allocator_name(call: ast.Call):
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _context_names(call: ast.Call):
    """Names the allocation binds to: walk up (via the ``_parent`` links
    SourceFile.parse attached) to the nearest assignment and collect its
    target identifiers — plus, for ``.to``/``.type``, the receiver's."""
    names = []
    if isinstance(call.func, ast.Attribute) and call.func.attr in _CASTS:
        names.extend(_names_in(call.func.value))
    node: ast.AST = call
    while node is not None:
        parent = getattr(node, "_parent", None)
        if isinstance(parent, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                parent.targets
                if isinstance(parent, ast.Assign)
                else [parent.target]
            )
            for t in targets:
                names.extend(_names_in(t))
            break
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Module)):
            break
        node = parent
    return names


class StateDtype(SourceRule):
    name = "state-dtype"

    def check_file(self, src: SourceFile) -> List[Finding]:
        path = src.path.replace("\\", "/")
        if any(path.endswith(s) for s in _EXEMPT_SUFFIX):
            return []
        if src.tree is None:
            return [self.finding(
                Severity.ERROR, src.path, "file does not parse", lineno=0,
            )]
        findings: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            alloc = _allocator_name(node)
            if alloc not in ALLOCATORS:
                continue
            dtype = _dtype_literal_in_call(node)
            if dtype is None:
                continue
            if not any(STATEISH.search(n) for n in _context_names(node)):
                continue
            if self.waived(src, node.lineno):
                continue
            findings.append(self.finding(
                Severity.ERROR, src.path,
                f"state allocation pins dtype {dtype} via {alloc}() — take "
                f"the width from core/statespec.StateSpec (or waive with "
                f"'# {self.name}: ok')",
                lineno=node.lineno,
            ))
        return findings
