"""FFI-lifetime lint: callbacks crossing into C must be kept alive.

The classic ctypes crash: a ``CFUNCTYPE`` object passed to C is a
Python object like any other — if the only reference is the argument
expression, the GC collects it while C still holds the raw pointer, and
the next native callback jumps through freed memory.  It works in every
test (the GC hasn't run yet) and segfaults in production.

This pass finds every call to a ``tb_*`` entry point whose SIGNATURES
argtype is a CFUNCTYPE class and checks, structurally, that the
callback argument is a *retained* reference:

- a module-level binding (``@RELEASE_FN``-decorated function or a
  module-level ``X = CFUNCTYPE(...)`` assignment), or
- a ``self.<attr>`` the enclosing class assigns somewhere
  (``self._frame_cb = FRAME_FN(...)`` before registration).

Inline construction at the call site (``LIB.tb_server_set_frame_cb(s,
FRAME_FN(f), None)``) and locals that die with the frame are
violations (``ffi-keepalive``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from incubator_brpc_tpu_torch.tools.fabriclint import (
    PORT,
    Target,
    Violation,
    allowed,
    iter_py_files,
    scan_annotations,
)


def _callback_positions(target: Target = PORT) -> Dict[str, List[int]]:
    """tb_* function -> indices of CFUNCTYPE-typed arguments."""

    import ctypes

    native = target.native()
    out: Dict[str, List[int]] = {}
    for name, (_res, argtypes) in native.SIGNATURES.items():
        idxs = [
            i
            for i, t in enumerate(argtypes)
            if isinstance(t, type) and issubclass(t, ctypes._CFuncPtr)
        ]
        if idxs:
            out[name] = idxs
    return out


class _ClassAttrs(ast.NodeVisitor):
    """Map of class name -> attrs assigned via ``self.X = ...``."""

    def __init__(self) -> None:
        self.attrs: Dict[str, Set[str]] = {}
        self._stack: List[str] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.attrs.setdefault(node.name, set())
        self.generic_visit(node)
        self._stack.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._stack:
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    self.attrs[self._stack[-1]].add(tgt.attr)
        self.generic_visit(node)


def _module_level_names(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    names.add(tgt.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add(a.asname or a.name.split(".")[0])
    return names


def check_source(
    path: str, source: str, target: Target = PORT
) -> List[Violation]:
    cb_pos = _callback_positions(target)
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    ann = scan_annotations(path, source)
    out: List[Violation] = []
    module_names = _module_level_names(tree)
    cls_attrs = _ClassAttrs()
    cls_attrs.visit(tree)

    # enclosing class per call node: walk with a stack
    def _walk(node: ast.AST, cls: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            cls = node.name
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            fname = node.func.attr
            if fname in cb_pos:
                for i in cb_pos[fname]:
                    if i >= len(node.args):
                        continue
                    arg = node.args[i]
                    ok = False
                    what = ast.dump(arg)[:40]
                    if isinstance(arg, ast.Name):
                        ok = arg.id in module_names
                        what = arg.id
                    elif isinstance(arg, ast.Attribute):
                        what = arg.attr
                        if (
                            isinstance(arg.value, ast.Name)
                            and arg.value.id == "self"
                        ):
                            ok = cls is not None and arg.attr in (
                                cls_attrs.attrs.get(cls, set())
                            )
                        else:
                            # module.attr is retained by the module; an
                            # attribute on a frame-local (holder.cb where
                            # holder dies with the frame) is NOT
                            ok = isinstance(
                                arg.value, ast.Name
                            ) and arg.value.id in module_names
                    if not ok and not allowed(
                        ann, "ffi-keepalive", node.lineno
                    ):
                        out.append(
                            Violation(
                                "ffi-keepalive", path, node.lineno,
                                f"{fname} callback argument {what!r} has "
                                "no keepalive binding — the GC can free "
                                "it while C still holds the pointer "
                                "(store it on self/module first)",
                            )
                        )
        for child in ast.iter_child_nodes(node):
            _walk(child, cls)

    _walk(tree, None)
    return out


def check(
    paths: Optional[List[str]] = None, target: Target = PORT
) -> List[Violation]:
    out: List[Violation] = []
    for path in (
        paths
        if paths is not None
        else iter_py_files(include_tests=True, target=target)
    ):
        with open(path, "r") as fh:
            source = fh.read()
        out.extend(check_source(path, source, target))
    return out
