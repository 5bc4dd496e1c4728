"""fabriclint over the port: static analysis of the FFI boundary and the
hot path of ``incubator_brpc_tpu_torch``.

The port's native host runtime is C++ (``csrc/host/tbutil`` and
``csrc/host/tbnet``) reached from Python through a hand-kept ctypes table
(``native.SIGNATURES``): a seam where drift corrupts silently instead of
failing loudly. The passes, one module each:

- **ffi** (ffi_check.py): the ``extern "C"`` declarations of the two
  headers, parsed (cdecl.py), against ``native.SIGNATURES``: names, arity,
  integer width and signedness, callback (CFUNCTYPE) layouts, and struct
  layouts (the ctypes mirror and the telemetry drain's numpy dtype).
- **hotpath** (hotpath.py): functions marked ``# fabriclint: hotpath``
  must not acquire locks, log, do I/O, or run per-record Python loops.
- **registry** (registry_lint.py): every ``define_flag`` is read somewhere
  and carries help text; exposed bvar names are valid Prometheus
  identifiers and the ``native_*``/``mc_*`` families are listed in the
  package's ``OBSERVABILITY.md``.
- **lifetime** (lifetime.py): every C callback registered from Python is
  held by a keep-alive before it crosses the FFI.
- **errcheck** (errcheck.py): no ``LIB.tb_*`` call with an
  error-indicating return is silently discarded.

Every checker reads a ``Target``: the package it scans, the two headers,
the module holding ``SIGNATURES`` and the struct and callback mirrors,
the module of the native-method callback mirror, and the bvar document.
The default, ``PORT``, is this package's own. Run everything with
``python -m incubator_brpc_tpu_torch.tools.fabriclint``; the sanitizer
harness is ``python -m incubator_brpc_tpu_torch.tools.fabriclint.san``.

Exemptions are inline and reasoned::

    # fabriclint: allow(<rule>) <non-empty reason>

on the violating line or the line above it. An empty reason is itself a
violation (``bad-allow``): the annotation documents *why* the rule does
not apply, not merely that someone silenced it.
"""

from __future__ import annotations

import glob
import importlib
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

PKG_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
REPO_ROOT = os.path.dirname(PKG_DIR)


@dataclass(frozen=True)
class Target:
    """What the checkers read. ``package`` is the directory under
    ``REPO_ROOT`` whose Python they scan; ``headers`` are tbutil.h then
    tbnet.h; ``native_module`` holds ``SIGNATURES`` and the struct and
    callback mirrors; ``plane_module`` holds ``NATIVE_METHOD_FN`` and the
    telemetry drain's dtype; ``bvar_doc`` lists the ``native_*``/``mc_*``
    bvar families."""

    package: str = "incubator_brpc_tpu_torch"
    headers: Tuple[str, str] = (
        os.path.join(PKG_DIR, "csrc", "host", "tbutil", "tbutil.h"),
        os.path.join(PKG_DIR, "csrc", "host", "tbnet", "tbnet.h"),
    )
    native_module: str = "incubator_brpc_tpu_torch.native"
    plane_module: str = "incubator_brpc_tpu_torch.transport.native_plane"
    bvar_doc: str = os.path.join(PKG_DIR, "OBSERVABILITY.md")

    def native(self):
        return importlib.import_module(self.native_module)

    def plane(self):
        return importlib.import_module(self.plane_module)


PORT = Target()

# Rules owned by the sibling concurrency checker (fabricverify).
# They are registered here because the two tools share ONE annotation
# grammar: a single ``# fabriclint: allow(<rule>) <reason>`` scanner must
# recognize every rule either tool can fire, or a legitimate fabricverify
# exemption would be reported as bad-allow by fabriclint and vice versa.
VERIFY_RULES = (
    "lock-cycle",       # cycle in the global lock-ordering graph
    "lock-unmodeled",   # a lock primitive the analyzer could not bind
    "lifecycle-borrow",     # SimpleDataPool.borrow with no give_back path
    "lifecycle-timer",      # TimerThread.schedule with no unschedule path
    "lifecycle-callback",   # hook registration with no teardown removal
    "model-stuck",          # reachable model state with no enabled action
    "model-unsafe",         # reachable state violating a safety property
    "model-unrevivable",    # state from which recovery is unreachable
)

# Rules owned by the C++-plane analyzer (fabricscan) — registered
# here for the same reason as VERIFY_RULES: one annotation grammar, one
# scanner validating every allow() either tool can exempt.
SCAN_RULES = (
    "wire-bounds",      # tainted wire length reaches a sink unguarded
    "ownership",        # owned field touched from the wrong thread role
    "owner-missing",    # mutable shared C++ state with no declared owner
    "plane-parity",     # a mirrored constant drifted between the planes
    "scan-parse",       # C++ the model/extractors could not cover
)

RULES = (
    "ffi-missing",      # sigs entry with no header declaration
    "ffi-unbound",      # header function with no sigs entry
    "ffi-arity",        # argument count mismatch
    "ffi-type",         # width/signedness/kind mismatch
    "ffi-callback",     # CFUNCTYPE layout mismatch vs header typedef
    "ffi-struct",       # struct layout mismatch (ctypes or numpy dtype)
    "ffi-parse",        # declaration the header parser could not model
    "hotpath-lock",
    "hotpath-log",
    "hotpath-io",
    "hotpath-loop",
    "flag-dead",
    "flag-undocumented",
    "bvar-name",
    "bvar-undocumented",
    "ffi-keepalive",
    "ffi-unchecked",
    "bad-allow",
) + VERIFY_RULES + SCAN_RULES


@dataclass
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        rel = os.path.relpath(self.path, REPO_ROOT)
        return f"{rel}:{self.line}: [{self.rule}] {self.message}"


def to_records(violations: Iterable["Violation"]) -> List[Dict[str, object]]:
    """Violations as ``{rule, file, line, reason}`` records — the
    machine-readable report schema shared by ``--json`` on fabriclint and
    fabricverify, stable so CI tooling can diff violation sets across
    commits (files repo-relative, one record per violation)."""

    return [
        {
            "rule": v.rule,
            "file": os.path.relpath(v.path, REPO_ROOT),
            "line": v.line,
            "reason": v.message,
        }
        for v in violations
    ]


_ALLOW_RE = re.compile(
    r"(?:#|//)\s*fabriclint:\s*allow\(([a-z0-9-]+)\)\s*(.*)$"
)
_HOTPATH_RE = re.compile(r"#\s*fabriclint:\s*hotpath\b")


@dataclass
class Annotations:
    """Per-file fabriclint comment annotations."""

    # line -> list of (rule, reason)
    allows: Dict[int, List[Tuple[str, str]]] = field(default_factory=dict)
    hotpath_lines: List[int] = field(default_factory=list)
    bad: List[Violation] = field(default_factory=list)  # malformed allows


def scan_annotations(path: str, source: Optional[str] = None) -> Annotations:
    """Collect ``# fabriclint:`` comments with their line numbers.

    Works for Python (via tokenize, so strings containing the marker
    text don't count) and for C/C++ headers (line-regex fallback).
    """

    if source is None:
        with open(path, "r") as fh:
            source = fh.read()
    ann = Annotations()

    def _record(line_no: int, text: str) -> None:
        m = _ALLOW_RE.search(text)
        if m:
            rule, reason = m.group(1), m.group(2).strip()
            if rule not in RULES:
                ann.bad.append(
                    Violation(
                        "bad-allow", path, line_no,
                        f"allow() names unknown rule {rule!r}",
                    )
                )
            elif not reason:
                ann.bad.append(
                    Violation(
                        "bad-allow", path, line_no,
                        f"allow({rule}) has no reason — exemptions must "
                        "say why the rule does not apply",
                    )
                )
            else:
                ann.allows.setdefault(line_no, []).append((rule, reason))
            return
        if _HOTPATH_RE.search(text):
            ann.hotpath_lines.append(line_no)

    if path.endswith((".h", ".hh", ".hpp", ".c", ".cc", ".cpp")):
        for i, ln in enumerate(source.split("\n"), 1):
            if "fabriclint:" in ln:
                _record(i, ln)
        return ann
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT and "fabriclint:" in tok.string:
                _record(tok.start[0], tok.string)
    except (tokenize.TokenError, SyntaxError, IndentationError):
        pass
    return ann


def allowed(ann: Annotations, rule: str, line: int) -> bool:
    """An allow applies to its own line and the line directly below it
    (i.e. written inline or on the line above the violating statement)."""

    for ln in (line, line - 1):
        for r, _reason in ann.allows.get(ln, ()):  # reason checked at scan
            if r == rule:
                return True
    return False


def iter_py_files(
    include_tests: bool = False, target: Target = PORT
) -> List[str]:
    """Product-code Python files in lint scope: the target package's tree,
    plus the port's tests (``tests/test_torch_*.py``) with
    ``include_tests``."""

    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(
        os.path.join(REPO_ROOT, target.package)
    ):
        dirnames[:] = [
            d for d in dirnames if d not in ("__pycache__", "build", "_build")
        ]
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    if include_tests:
        out.extend(
            sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "test_torch_*.py")))
        )
    return out


def run_all(target: Target = PORT) -> List[Violation]:
    """Run every checker over the target; returns unexempted violations."""

    from incubator_brpc_tpu_torch.tools.fabriclint import (
        errcheck,
        ffi_check,
        hotpath,
        lifetime,
        registry_lint,
    )

    out: List[Violation] = []
    out.extend(ffi_check.check(target=target))
    out.extend(hotpath.check(target=target))
    out.extend(registry_lint.check(target=target))
    out.extend(lifetime.check(target=target))
    out.extend(errcheck.check(target=target))
    # several passes scan the same files for annotations and each reports
    # malformed allows it sees: dedupe on identity
    seen = set()
    unique: List[Violation] = []
    for v in out:
        key = (v.rule, v.path, v.line, v.message)
        if key not in seen:
            seen.add(key)
            unique.append(v)
    return unique
