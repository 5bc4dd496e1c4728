"""Flag & bvar registry lint.

Flags (``define_flag``): every defined flag must be *read* somewhere in
product code (``get_flag``/``flag_registry.get`` with the literal name,
through any import alias) and must carry help text.  A flag nobody
reads is configuration theater — the operator flips it and nothing
changes (``flag-dead``); a flag without help is unusable from the
``/flags`` service (``flag-undocumented``).

Bvars: every name exposed into the metrics registry must be a valid
identifier for the Prometheus exposition (dots tolerated — the
exposition sanitizes them), and the ``native_*``/``mc_*`` families must
appear in the target's bvar document (the port's ``OBSERVABILITY.md``):
those two prefixes are the documented contract for the native plane and
the multi-controller plane (``bvar-name``/``bvar-undocumented``).  Names built from
f-strings or concatenation are checked by their literal prefix (the
part before the first runtime placeholder).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from incubator_brpc_tpu_torch.tools.fabriclint import (
    PORT,
    Target,
    Violation,
    allowed,
    iter_py_files,
    scan_annotations,
)

_BVAR_CTORS = {
    "Adder",
    "Maxer",
    "Miner",
    "IntRecorder",
    "LatencyRecorder",
    "PassiveStatus",
    "Status",
    "Window",
    "PerSecond",
}

_PLACEHOLDER = "\x00"
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:.]*$")


def _str_template(node: ast.AST, local: Dict[str, str]) -> Optional[str]:
    """Resolve an expression to a string template where runtime parts
    become a placeholder byte; None when it is not string-shaped."""

    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, str) else None
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append(_PLACEHOLDER)
        return "".join(parts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left = _str_template(node.left, local)
        right = _str_template(node.right, local)
        if left is None and right is None:
            return None
        return (left or _PLACEHOLDER) + (right or _PLACEHOLDER)
    if isinstance(node, ast.Name):
        return local.get(node.id)
    if isinstance(node, ast.Call):
        # "x".format(...) / name.replace(...) — runtime content
        return _PLACEHOLDER
    return None


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------


def _flag_aliases(tree: ast.Module, package: str) -> Tuple[Set[str], Set[str]]:
    """(names bound to get_flag, names bound to define_flag) in a file."""

    gets, defs = {"get_flag"}, {"define_flag"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
            node.module.endswith("utils.flags")
            or node.module == package + ".utils"
        ):
            for a in node.names:
                if a.name == "get_flag":
                    gets.add(a.asname or a.name)
                elif a.name == "define_flag":
                    defs.add(a.asname or a.name)
    return gets, defs


def _registry_method(node: ast.Call, method: str) -> bool:
    """True for ``flag_registry.<method>(...)`` specifically — a bare
    ``.get("name")``/``.define(...)`` on any other receiver is an
    ordinary dict/object call and must NOT count as a flag access
    (``sock.context.get("server")`` would otherwise mask a dead flag
    that happens to share a name with a dict key)."""

    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == method
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id in ("flag_registry", "registry")
    )


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _first_str_arg(node: ast.Call) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant) and isinstance(
        node.args[0].value, str
    ):
        return node.args[0].value
    return None


def check_flags(
    paths: Optional[List[str]] = None, target: Target = PORT
) -> List[Violation]:
    product = [
        p
        for p in (paths if paths is not None else iter_py_files(target=target))
        if os.sep + "tools" + os.sep + "fabriclint" not in p
    ]
    defined: Dict[str, Tuple[str, int, bool]] = {}
    read: Set[str] = set()
    anns = {}
    for path in product:
        with open(path, "r") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        anns[path] = scan_annotations(path, source)
        gets, defs = _flag_aliases(tree, target.package)
        in_pkg = os.sep + target.package + os.sep in path
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            cname = _call_name(node)
            arg = _first_str_arg(node)
            if arg is None:
                continue
            if cname in defs or _registry_method(node, "define"):
                if in_pkg:  # flags are a framework-level registry
                    has_help = any(
                        k.arg == "help" for k in node.keywords
                    ) or (
                        len(node.args) > 2
                        and isinstance(node.args[2], ast.Constant)
                        and isinstance(node.args[2].value, str)
                        and node.args[2].value.strip() != ""
                    )
                    defined.setdefault(arg, (path, node.lineno, has_help))
            elif cname in gets or _registry_method(node, "get"):
                read.add(arg)
    out: List[Violation] = []
    for name, (path, line, has_help) in sorted(defined.items()):
        ann = anns.get(path)
        if name not in read:
            if ann is None or not allowed(ann, "flag-dead", line):
                out.append(
                    Violation(
                        "flag-dead", path, line,
                        f"flag {name!r} is defined but never read "
                        "(get_flag) anywhere in product code",
                    )
                )
        if not has_help:
            if ann is None or not allowed(ann, "flag-undocumented", line):
                out.append(
                    Violation(
                        "flag-undocumented", path, line,
                        f"flag {name!r} has no help text — it is "
                        "unreadable from the /flags service",
                    )
                )
    return out


# ---------------------------------------------------------------------------
# bvars
# ---------------------------------------------------------------------------


def _collect_bvar_names(
    tree: ast.Module,
) -> List[Tuple[str, int]]:
    """(name template, line) for every statically-visible exposure."""

    out: List[Tuple[str, int]] = []
    # local single-assignment string templates, resolved per function so
    # `base = "native_method_" + ...; recorder.expose(base)` is checked
    for fn in [
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module))
    ]:
        local: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and (
                isinstance(node.targets[0], ast.Name)
            ):
                t = _str_template(node.value, local)
                if t is not None:
                    local[node.targets[0].id] = t
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            cname = _call_name(node)
            if cname in _BVAR_CTORS:
                for kw in node.keywords:
                    if kw.arg == "name":
                        t = _str_template(kw.value, local)
                        if t is not None:
                            out.append((t, node.lineno))
            elif cname == "expose" and node.args:
                t = _str_template(node.args[0], local)
                if t is not None:
                    out.append((t, node.lineno))
    # dedupe (module walk + function walks see nested nodes twice)
    return sorted(set(out), key=lambda x: x[1])


def check_bvars(
    paths: Optional[List[str]] = None, target: Target = PORT
) -> List[Violation]:
    with open(target.bvar_doc, "r") as fh:
        doc = fh.read()
    doc_name = os.path.basename(target.bvar_doc)
    out: List[Violation] = []
    scope = [
        p
        for p in (paths if paths is not None else iter_py_files(target=target))
        if os.sep + target.package + os.sep in p
    ]
    for path in scope:
        with open(path, "r") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source)
        except SyntaxError:
            continue
        ann = scan_annotations(path, source)
        for template, line in _collect_bvar_names(tree):
            probe = template.replace(_PLACEHOLDER, "x0")
            if not _NAME_RE.match(probe):
                if not allowed(ann, "bvar-name", line):
                    out.append(
                        Violation(
                            "bvar-name", path, line,
                            f"bvar name {template.replace(_PLACEHOLDER, '{}')!r}"
                            " is not a valid metric identifier "
                            "([a-zA-Z_:][a-zA-Z0-9_:.]*)",
                        )
                    )
                continue
            prefix = template.split(_PLACEHOLDER, 1)[0]
            display = template.replace(_PLACEHOLDER, "{}")
            if not (
                prefix.startswith("native_") or prefix.startswith("mc_")
            ):
                continue
            if _PLACEHOLDER not in template:
                documented = template in doc
                what = f"bvar {template!r}"
            else:
                # templated family: the literal prefix is the contract
                documented = len(prefix) >= 8 and prefix in doc
                what = f"bvar family {display!r} (prefix {prefix!r})"
            if not documented and not allowed(ann, "bvar-undocumented", line):
                out.append(
                    Violation(
                        "bvar-undocumented", path, line,
                        f"{what} follows the native_*/mc_* convention but "
                        f"is not documented in {doc_name}",
                    )
                )
    return out


def check(
    paths: Optional[List[str]] = None, target: Target = PORT
) -> List[Violation]:
    return check_flags(paths, target) + check_bvars(paths, target)
