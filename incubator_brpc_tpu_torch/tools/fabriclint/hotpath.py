"""Hot-path purity checker.

Functions marked with a ``# fabriclint: hotpath`` comment directly
above their ``def`` (or first decorator) sit on the native plane's
per-request or per-batch path: the telemetry drain batch, the frame
cut/dispatch shims, the limiter's ``on_responded``, the overlap
scheduler's chunk probe.  Python-level per-record work there taxes every
request; this pass makes that class of regression a lint failure
instead of a slower run found later.

Inside a hotpath function the checker forbids:

- ``hotpath-lock`` — acquiring locks (``with ...lock``, ``.acquire()``,
  constructing ``threading.Lock``/``RLock``/``Condition``);
- ``hotpath-log`` — calls through ``logger``/``logging``;
- ``hotpath-io`` — ``print``/``open``/``input``, ``time.sleep``, and
  calls into ``os``/``subprocess``/``socket`` modules;
- ``hotpath-loop`` — any Python-level loop or comprehension: per-record
  iteration belongs in numpy (vectorized batch ops); a loop that is
  genuinely bounded by something small (distinct methods, decimated
  samples) carries an ``allow`` with the bound as the reason.

``except`` handler bodies are exempt wholesale — error paths are off
the hot path and may log/close freely.  Exemptions:
``# fabriclint: allow(<rule>) <reason>`` on the statement's first line
or the line above.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from incubator_brpc_tpu_torch.tools.fabriclint import (
    PORT,
    Annotations,
    Target,
    Violation,
    allowed,
    iter_py_files,
    scan_annotations,
)

_IO_NAMES = {"print", "open", "input"}
_IO_MODULES = {"os", "subprocess", "socket", "shutil"}
_LOG_NAMES = {"logger", "logging", "log"}
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def _attr_chain(node: ast.AST) -> List[str]:
    """['self', '_tel_lock'] for self._tel_lock; [] when not a chain."""

    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _looks_like_lock(expr: ast.AST) -> bool:
    chain = _attr_chain(expr)
    if chain and "lock" in chain[-1].lower():
        return True
    if isinstance(expr, ast.Call):
        c = _attr_chain(expr.func)
        if c and (c[-1] in _LOCK_CTORS or "lock" in c[-1].lower()):
            return True
    return False


class _HotpathVisitor(ast.NodeVisitor):
    def __init__(self, path: str, ann: Annotations):
        self.path = path
        self.ann = ann
        self.out: List[Violation] = []

    def _add(self, rule: str, node: ast.AST, msg: str) -> None:
        line = getattr(node, "lineno", 1)
        if not allowed(self.ann, rule, line):
            self.out.append(Violation(rule, self.path, line, msg))

    # -- rules -------------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            if _looks_like_lock(item.context_expr):
                src = ".".join(_attr_chain(item.context_expr)) or "<expr>"
                self._add(
                    "hotpath-lock", node,
                    f"lock acquisition on the hot path: with {src}",
                )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain:
            if chain[-1] == "acquire" and len(chain) > 1:
                self._add(
                    "hotpath-lock", node,
                    f"lock acquisition on the hot path: "
                    f"{'.'.join(chain)}()",
                )
            if chain[0] in _LOG_NAMES and len(chain) > 1:
                self._add(
                    "hotpath-log", node,
                    f"logging on the hot path: {'.'.join(chain)}()",
                )
            if len(chain) == 1 and chain[0] in _IO_NAMES:
                self._add(
                    "hotpath-io", node,
                    f"I/O on the hot path: {chain[0]}()",
                )
            if len(chain) > 1 and chain[0] in _IO_MODULES:
                self._add(
                    "hotpath-io", node,
                    f"I/O on the hot path: {'.'.join(chain)}()",
                )
            if chain[:2] == ["time", "sleep"]:
                self._add(
                    "hotpath-io", node, "time.sleep() on the hot path"
                )
            if (
                len(chain) == 2
                and chain[0] == "threading"
                and chain[1] in _LOCK_CTORS
            ):
                self._add(
                    "hotpath-lock", node,
                    f"lock construction on the hot path: "
                    f"{'.'.join(chain)}()",
                )
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._add(
            "hotpath-loop", node,
            "Python-level loop on the hot path — vectorize over the "
            "batch, or allow() with the loop's bound as the reason",
        )
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._add(
            "hotpath-loop", node,
            "Python-level loop on the hot path — vectorize over the "
            "batch, or allow() with the loop's bound as the reason",
        )
        self.generic_visit(node)

    def _comp(self, node) -> None:
        self._add(
            "hotpath-loop", node,
            "Python-level comprehension on the hot path — vectorize, "
            "or allow() with the bound as the reason",
        )
        self.generic_visit(node)

    visit_ListComp = _comp
    visit_SetComp = _comp
    visit_DictComp = _comp
    visit_GeneratorExp = _comp

    # -- error paths are off the hot path ----------------------------------

    def visit_Try(self, node: ast.Try) -> None:
        for stmt in node.body + node.orelse + node.finalbody:
            self.visit(stmt)
        # handlers skipped: error paths may log/close/clean up freely


def _marked_functions(tree: ast.Module, marker_lines: Set[int]) -> list:
    """FunctionDefs whose def (or first decorator) sits directly under a
    ``# fabriclint: hotpath`` comment line."""

    out = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.lineno
            if node.decorator_list:
                first = min(d.lineno for d in node.decorator_list)
            if (first - 1) in marker_lines or first in marker_lines:
                out.append(node)
    return out


def check_source(path: str, source: str) -> List[Violation]:
    ann = scan_annotations(path, source)
    out: List[Violation] = list(ann.bad)
    if not ann.hotpath_lines:
        return out
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return out + [
            Violation("hotpath-loop", path, e.lineno or 1, "unparsable file")
        ]
    marked = _marked_functions(tree, set(ann.hotpath_lines))
    for fn in marked:
        visitor = _HotpathVisitor(path, ann)
        for stmt in fn.body:
            visitor.visit(stmt)
        out.extend(visitor.out)
    # a marker that doesn't sit above a def guards nothing — flag it so
    # a drive-by reformat can't silently detach the contract
    claimed = set()
    for fn in marked:
        first = fn.lineno
        if fn.decorator_list:
            first = min(d.lineno for d in fn.decorator_list)
        claimed.update({first - 1, first})
    for ln in ann.hotpath_lines:
        if ln not in claimed:
            out.append(
                Violation(
                    "bad-allow", path, ln,
                    "hotpath marker is not attached to a function "
                    "definition (put it on the line above the def)",
                )
            )
    return out


def marked_qualnames(source: str) -> List[str]:
    """Qualified names (``Class.method``) of the functions a source marks
    ``hotpath``, in source order."""

    tree = ast.parse(source)
    ann = scan_annotations("<source>.py", source)
    marked = set(_marked_functions(tree, set(ann.hotpath_lines)))
    out: List[str] = []

    def _walk(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if child in marked:
                out.append(prefix + child.name)
            if isinstance(child, ast.ClassDef):
                _walk(child, prefix + child.name + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _walk(child, prefix + child.name + ".<locals>.")

    _walk(tree, "")
    return out


def check(
    paths: Optional[List[str]] = None, target: Target = PORT
) -> List[Violation]:
    out: List[Violation] = []
    for path in paths if paths is not None else iter_py_files(target=target):
        if os.path.basename(path) == "__main__.py" and "fabriclint" in path:
            continue
        with open(path, "r") as fh:
            source = fh.read()
        out.extend(check_source(path, source))
    return out
