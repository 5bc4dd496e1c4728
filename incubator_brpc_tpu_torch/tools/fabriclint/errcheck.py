"""tb_* error-code audit.

A discarded return code of ``tb_server_register_native`` would let the
method-index table desynchronize from the C++ table and corrupt
telemetry attribution.  This pass makes the class impossible: every call to a ``tb_*`` entry point
whose declared restype is an error indicator (``c_int`` / ``c_long`` —
the headers' 0/-errno/-1 convention) must USE the return value.  A call
appearing as a bare expression statement discards it; that is an
``ffi-unchecked`` violation unless the line carries an explicit

    # fabriclint: allow(ffi-unchecked) <why the code is meaningless here>

which is the "explicitly voided" form — the reason documents why (e.g.
closing a connection that is already being torn down, where a stale
token is the expected case, not an error).
"""

from __future__ import annotations

import ast
import ctypes
from typing import List, Optional, Set

from incubator_brpc_tpu_torch.tools.fabriclint import (
    PORT,
    Target,
    Violation,
    allowed,
    iter_py_files,
    scan_annotations,
)


def _error_returning(target: Target = PORT) -> Set[str]:
    native = target.native()
    out: Set[str] = set()
    for name, (restype, _args) in native.SIGNATURES.items():
        if restype in (ctypes.c_int, ctypes.c_long):
            out.add(name)
    return out


def check_source(
    path: str, source: str, target: Target = PORT
) -> List[Violation]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    must_check = _error_returning(target)
    ann = scan_annotations(path, source)
    out: List[Violation] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
            continue
        call = node.value
        fname = None
        if isinstance(call.func, ast.Attribute):
            fname = call.func.attr
        elif isinstance(call.func, ast.Name):
            fname = call.func.id
        if fname in must_check:
            if not allowed(ann, "ffi-unchecked", node.lineno):
                out.append(
                    Violation(
                        "ffi-unchecked", path, node.lineno,
                        f"{fname} returns an error code that is "
                        "discarded — check it, or void it with an "
                        "allow(ffi-unchecked) reason",
                    )
                )
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
