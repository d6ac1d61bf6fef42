"""Rules: host-sync, lru-static-key (port of
``repro.analysis.rules.host_sync``; ``traced-callback`` has no counterpart,
as eager PyTorch traces nothing).

``host-sync`` enforces the one-fetch contract: a call that makes the host
wait for the card — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
``synchronize()``, or ``bool(...)`` / ``int(...)`` / ``float(...)`` of a
torch expression — is allowed in library code only at a documented site
carrying a ``# host-sync: ok`` waiver with its reason. Anywhere else it
silently serializes the launch stream. Scoped to ``src/repro_torch/``, and
to the files there that import torch (nothing else can reach a card);
chip_smoke, tests and tools are host drivers and fetch freely.

What counts as a torch expression is decided from the source alone, as
far as the source shows it: a call of ``torch.*`` (outside ``torch.cuda``
and other host-side namespaces), a tensor method (``.any()``, ``.sum()``,
``.max()``, ...) on a receiver not bound to numpy, a call of a function of
the same module annotated to return a ``Tensor``, and names bound to any
of these or unpacked from a call's result (a tuple of tensors, as the
engine's passes return). An operand of an operator or a subscript carries
its operand's kind. Names of parameters annotated ``int``/``float``/
``bool`` and ``.shape``/``.dtype``-like attributes are host values.

``lru-static-key`` guards cache keys: an ``lru_cache``'d function must be
keyed on hashable statics only — a mutable default (list/dict/set) raises
at call time, and array-ish parameter names are a smell that a tensor
leaked into the cache key.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules.base import SourceFile, SourceRule

_ARRAYISH_PARAMS = {"u", "v", "edges", "state", "arr", "array"}

#: methods that fetch a tensor to the host (no arguments) or wait for it
_FETCHES = {"item", "tolist", "cpu", "numpy"}
#: tensor methods that return a tensor (a reduction or an elementwise op)
_TENSOR_METHODS = {
    "any", "all", "sum", "max", "min", "amax", "amin", "argmax", "argmin",
    "count_nonzero", "mean", "prod", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "isfinite", "isnan", "to",
    "long", "int", "bool", "float", "clone", "reshape", "view", "flatten",
    "squeeze",
}
#: ``torch.<name>`` namespaces and functions that stay on the host
_TORCH_HOST = {"cuda", "backends", "device", "dtype", "finfo", "iinfo",
               "Size", "is_tensor", "is_floating_point", "get_default_dtype",
               "Generator"}
#: attributes that are host values on a tensor or an array
_HOST_ATTRS = {"shape", "ndim", "dtype", "device", "size", "itemsize",
               "is_cuda", "requires_grad"}
_HOST_ANNOTATIONS = {"int", "float", "bool", "str"}
_NUMPY = {"np", "numpy"}


def _in_library(path: str) -> bool:
    p = path.replace("\\", "/")
    return "src/repro_torch/" in p or p.startswith("repro_torch/")


def _imports_torch(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "torch" for a in node.names):
            return True
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.split(".")[0] == "torch"):
            return True
    return False


def _root(node: ast.AST) -> Optional[str]:
    """The name at the root of an attribute/call/subscript chain."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            return None


def _annotation_text(node: Optional[ast.AST]) -> str:
    return ast.unparse(node) if node is not None else ""


class _Kinds:
    """What the source says about the kind of each name in one scope:
    ``"torch"``, ``"numpy"`` or ``"host"`` (absent: unknown)."""

    def __init__(self, scope: ast.AST, tensor_fns: set):
        self.tensor_fns = tensor_fns
        self.kinds: Dict[str, str] = {}
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = scope.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                ann = _annotation_text(arg.annotation)
                if "Tensor" in ann:
                    self.kinds[arg.arg] = "torch"
                elif ann in _HOST_ANNOTATIONS:
                    self.kinds[arg.arg] = "host"
        # two passes, so a name bound from another name bound later in the
        # text still resolves (loops)
        for _ in range(2):
            for node in ast.walk(scope):
                if isinstance(node, ast.Assign):
                    self._bind(node.targets, node.value)
                elif isinstance(node, ast.AnnAssign) and node.value:
                    self._bind([node.target], node.value)

    def _bind(self, targets, value) -> None:
        for t in targets:
            if isinstance(t, ast.Name):
                kind = self.kind(value)
                if kind is not None:
                    self.kinds[t.id] = kind
            elif isinstance(t, ast.Tuple) and isinstance(value, ast.Call):
                # unpacked from a call: a tuple of tensors unless the call
                # is numpy's or a builtin's
                kind = self.kind(value)
                if kind is None and _root(value) not in _NUMPY | {
                        "zip", "enumerate", "range", "divmod", "map"}:
                    kind = "torch"
                for elt in t.elts:
                    if isinstance(elt, ast.Name) and kind is not None:
                        self.kinds[elt.id] = kind

    def kind(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant):
            return "host"
        if isinstance(node, ast.Name):
            if node.id in _NUMPY:
                return "numpy"
            return self.kinds.get(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in _HOST_ATTRS:
                return "host"
            return None
        if isinstance(node, ast.Subscript):
            return self.kind(node.value)
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare,
                             ast.UnaryOp)):
            parts = [self.kind(n) for n in ast.iter_child_nodes(node)]
            for k in ("torch", "numpy"):
                if k in parts:
                    return k
            return None
        if isinstance(node, ast.Call):
            f = node.func
            root = _root(f)
            if root in _NUMPY:
                return "numpy"
            if isinstance(f, ast.Name):
                if f.id in self.tensor_fns:
                    return "torch"
                if f.id in ("len", "int", "float", "bool", "str", "range"):
                    return "host"
                return None
            if isinstance(f, ast.Attribute):
                if root == "torch":
                    return None if self._torch_host(f) else "torch"
                if f.attr in _TENSOR_METHODS:
                    recv = self.kind(f.value)
                    return recv if recv in ("numpy", "host") else "torch"
            return None
        return None

    @staticmethod
    def _torch_host(f: ast.Attribute) -> bool:
        node = f
        while isinstance(node.value, ast.Attribute):
            node = node.value
        return node.attr in _TORCH_HOST


def _scopes(tree: ast.AST):
    """Each function (and the module) with the nodes it owns directly."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _own_nodes(scope: ast.AST):
    todo = list(ast.iter_child_nodes(scope))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            todo.extend(ast.iter_child_nodes(node))


class HostSync(SourceRule):
    name = "host-sync"

    def check_file(self, src: SourceFile) -> List[Finding]:
        if (src.tree is None or not _in_library(src.path)
                or not _imports_torch(src.tree)):
            return []
        tensor_fns = {
            n.name for n in ast.walk(src.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and "Tensor" in _annotation_text(n.returns)
        }
        findings: List[Finding] = []
        for scope in _scopes(src.tree):
            kinds = _Kinds(scope, tensor_fns)
            for node in _own_nodes(scope):
                what = self._sync(node, kinds)
                if what is None or self.waived(src, node.lineno):
                    continue
                findings.append(self.finding(
                    Severity.ERROR, src.path,
                    f"{what} makes the host wait for the card outside the "
                    f"documented sites — keep the value on the card, route "
                    f"it through one fetch, or waive with "
                    f"'# {self.name}: ok' and the reason",
                    lineno=node.lineno,
                ))
        return sorted(findings, key=lambda f: f.lineno)

    @staticmethod
    def _sync(node: ast.AST, kinds: _Kinds) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr == "synchronize":
                return f"{ast.unparse(f)}()"
            if f.attr in _FETCHES and not node.args and not node.keywords:
                if kinds.kind(f.value) in ("numpy", "host") \
                        and f.attr != "item":
                    return None
                return f".{f.attr}()"
            return None
        if (isinstance(f, ast.Name) and f.id in ("bool", "int", "float")
                and len(node.args) == 1
                and kinds.kind(node.args[0]) == "torch"):
            return f"{f.id}() of a tensor"
        return None


class LruStaticKey(SourceRule):
    name = "lru-static-key"

    def check_file(self, src: SourceFile) -> List[Finding]:
        if src.tree is None:
            return []
        findings: List[Finding] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not any(self._is_lru(d) for d in node.decorator_list):
                continue
            if self.waived(src, node.lineno):
                continue
            a = node.args
            defaults = list(a.defaults) + list(a.kw_defaults or [])
            for d in defaults:
                if d is None:
                    continue
                if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(d, ast.Call)
                    and isinstance(d.func, ast.Name)
                    and d.func.id in ("list", "dict", "set")
                ):
                    findings.append(self.finding(
                        Severity.ERROR, src.path,
                        f"lru_cache'd `{node.name}` has an unhashable "
                        f"(mutable) default — every call raises or misses "
                        f"the cache; key builders on hashable statics only",
                        lineno=node.lineno,
                    ))
            for arg in list(a.args) + list(a.kwonlyargs) + list(
                a.posonlyargs
            ):
                if arg.arg in _ARRAYISH_PARAMS:
                    findings.append(self.finding(
                        Severity.WARNING, src.path,
                        f"lru_cache'd `{node.name}` takes parameter "
                        f"`{arg.arg}` — an array-ish name in a cache key "
                        f"suggests a tensor leaked into the builder "
                        f"signature (constant cache misses)",
                        lineno=node.lineno,
                    ))
        return findings

    @staticmethod
    def _is_lru(dec: ast.AST) -> bool:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(target, ast.Attribute):
            return target.attr == "lru_cache"
        if isinstance(target, ast.Name):
            return target.id == "lru_cache"
        return False
