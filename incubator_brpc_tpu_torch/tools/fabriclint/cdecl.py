"""Minimal C declaration parser for the tb_* C-ABI headers.

fabriclint's FFI checker needs the *shape* of every ``extern "C"``
surface in csrc/host/tbutil/tbutil.h and csrc/host/tbnet/tbnet.h: function
declarations (return type, argument types), function-pointer typedefs
(callback layouts), and struct layouts (field offsets/widths under
natural alignment).  The headers are deliberately plain C89-style
declarations — no macros in signatures, no nested parens except in
function-pointer typedefs — so a tokenizing parser a few hundred lines
long covers them completely, and anything it cannot parse is reported
as a violation rather than skipped (an unparsed declaration is an
unchecked declaration).

This is NOT a general C parser.  It exists so the hand-maintained
ctypes table in the port's native.py can be diffed against the
compiler-enforced truth on every test run.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# canonical type model
# ---------------------------------------------------------------------------

# scalar name -> (bits, signed).  LP64 (the only ABI the native plane
# builds for: native.py compiles it with g++ on linux-gnu).
SCALARS: Dict[str, Tuple[int, bool]] = {
    "char": (8, True),
    "int8_t": (8, True),
    "uint8_t": (8, False),
    "int16_t": (16, True),
    "uint16_t": (16, False),
    "int": (32, True),
    "unsigned": (32, False),
    "int32_t": (32, True),
    "uint32_t": (32, False),
    "long": (64, True),
    "int64_t": (64, True),
    "uint64_t": (64, False),
    "size_t": (64, False),
    "ssize_t": (64, True),
    # deliberately NO floating-point entries: float/double pass in xmm
    # registers on SysV AMD64, so modeling them as 64-bit integers would
    # bless an ABI-broken integer binding.  The current ABI has no float
    # parameters; if one is ever added, its declaration lands in
    # `unparsed` (an ffi-parse violation) until float support is added
    # here AND in ffi_check's ctypes mapping, both deliberately.
}


@dataclass(frozen=True)
class CType:
    """Canonical C type: a scalar, void, or a pointer.

    kind: "void" | "scalar" | "ptr"
    For scalars, ``bits``/``signed_`` describe the width.  For
    pointers, ``pointee`` names what is pointed at:
      "void", "char", "scalar:<name>", "struct:<name>",
      "opaque:<name>", "fn:<typedef name>".
    """

    kind: str
    bits: int = 0
    signed_: bool = True
    pointee: str = ""

    def __str__(self) -> str:  # diagnostics only
        if self.kind == "ptr":
            return f"{self.pointee}*"
        if self.kind == "scalar":
            return f"{'i' if self.signed_ else 'u'}{self.bits}"
        return self.kind


@dataclass
class CFunc:
    name: str
    ret: CType
    args: List[CType]
    line: int  # 1-based line in the header (diagnostics)


@dataclass
class CFuncPtr:
    name: str
    ret: CType
    args: List[CType]
    line: int


@dataclass
class CStructField:
    name: str
    bits: int
    signed_: bool
    offset_bits: int
    is_ptr: bool = False


@dataclass
class CStruct:
    name: str
    fields: List[CStructField]
    size_bits: int
    line: int


@dataclass
class Header:
    path: str
    funcs: Dict[str, CFunc] = field(default_factory=dict)
    funcptrs: Dict[str, CFuncPtr] = field(default_factory=dict)
    structs: Dict[str, CStruct] = field(default_factory=dict)
    opaques: List[str] = field(default_factory=list)
    unparsed: List[Tuple[int, str]] = field(default_factory=list)


# ---------------------------------------------------------------------------
# lexing helpers
# ---------------------------------------------------------------------------


def _strip_comments(text: str) -> str:
    """Blank out comments, preserving newlines so line numbers survive."""

    out = []
    i, n = 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i)
            j = n - 2 if j < 0 else j
            out.append("".join(c if c == "\n" else " " for c in text[i : j + 2]))
            i = j + 2
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def _strip_cpp(text: str) -> str:
    """Blank preprocessor lines and the extern "C" scaffolding.

    Both the opening ``extern "C" {`` and its lone closing ``}`` are
    blanked so the chunk splitter's brace-depth tracking only ever sees
    struct braces — otherwise the closer would drive depth negative and
    any declaration after the block would be mis-split.
    """

    lines = []
    for ln in text.split("\n"):
        s = ln.strip()
        if s.startswith("#") or s == "}":
            lines.append("")
        elif s.startswith('extern "C"'):
            rest = s[len('extern "C"') :].strip()
            if rest in ("", "{"):
                lines.append("")  # the block form: scaffolding only
            else:
                # one-line form (`extern "C" int f(...);`): keep the
                # declaration so it is parsed/reported, not vanished
                lines.append(ln.replace('extern "C"', "          ", 1))
        else:
            lines.append(ln)
    return "\n".join(lines)


def parse_type(spec: str, header: "Header") -> Optional[CType]:
    """Canonicalize one C type spec (parameter name already removed)."""

    toks = spec.replace("*", " * ").split()
    toks = [t for t in toks if t not in ("const", "volatile", "struct")]
    stars = toks.count("*")
    base = [t for t in toks if t != "*"]
    if not base:
        return None
    if len(base) == 2 and base == ["unsigned", "int"]:
        base = ["unsigned"]
    if len(base) != 1:
        return None
    name = base[0]
    if stars == 0:
        if name == "void":
            return CType("void")
        if name in SCALARS:
            bits, sg = SCALARS[name]
            return CType("scalar", bits, sg)
        if name in header.funcptrs:  # callback passed by typedef value
            return CType("ptr", pointee=f"fn:{name}")
        return None
    if stars == 1:
        if name == "void":
            return CType("ptr", pointee="void")
        if name == "char":
            return CType("ptr", pointee="char")
        if name in header.structs:
            return CType("ptr", pointee=f"struct:{name}")
        if name in header.opaques:
            return CType("ptr", pointee=f"opaque:{name}")
        if name in SCALARS:
            return CType("ptr", pointee=f"scalar:{name}")
        return None
    return None  # ** never appears on this ABI except in fn-ptr typedef args


_SPLIT_ARGS = re.compile(r",")


def _parse_arglist(arglist: str, header: Header) -> Optional[List[CType]]:
    arglist = arglist.strip()
    if arglist in ("", "void"):
        return []
    out: List[CType] = []
    for raw in _SPLIT_ARGS.split(arglist):
        raw = raw.strip()
        if not raw:
            return None
        # drop the parameter name: the last identifier, unless the spec is
        # a bare type ("tb_iobuf* body" -> drop "body"; "size_t" -> keep).
        m = re.match(r"^(.*?)([A-Za-z_][A-Za-z0-9_]*)$", raw)
        spec = raw
        if m:
            head = m.group(1).strip()
            # "char** resp": head "char**" is a full type; "uint64_t" with
            # empty head is the type itself, keep it.
            if head:
                spec = head
        t = parse_type(spec, header)
        if t is None and m and m.group(1).strip() == "":
            t = parse_type(raw, header)  # unnamed parameter
        if t is None and spec.replace(" ", "").endswith("**"):
            # pointer-to-pointer out-param (tb_native_fn's char** resp):
            # canonically just "a pointer slot the callee fills"
            t = CType("ptr", pointee="ptr")
        if t is None:
            return None
        out.append(t)
    return out


_FUNCPTR_RE = re.compile(
    r"^typedef\s+(?P<ret>[A-Za-z_][A-Za-z0-9_ ]*?\**)\s*"
    r"\(\s*\*\s*(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*\)\s*"
    r"\((?P<args>.*)\)$",
    re.S,
)
_OPAQUE_RE = re.compile(
    r"^typedef\s+struct\s+(?P<tag>[A-Za-z_][A-Za-z0-9_]*)\s+(?P<name>[A-Za-z_][A-Za-z0-9_]*)$"
)
_STRUCT_RE = re.compile(
    r"^typedef\s+struct(?:\s+[A-Za-z_][A-Za-z0-9_]*)?\s*\{(?P<body>.*)\}\s*"
    r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)$",
    re.S,
)
_FUNC_RE = re.compile(
    r"^(?P<ret>[A-Za-z_][A-Za-z0-9_ ]*?\**)\s*"
    r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*\((?P<args>.*)\)$",
    re.S,
)


def _parse_struct_body(
    body: str, header: Header
) -> Optional[Tuple[List[CStructField], int]]:
    fields: List[CStructField] = []
    offset = 0
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r"^(.*?)([A-Za-z_][A-Za-z0-9_]*)$", decl)
        if not m:
            return None
        spec, fname = m.group(1).strip(), m.group(2)
        t = parse_type(spec, header)
        if t is None:
            return None
        if t.kind == "ptr":
            bits, sg, is_ptr = 64, False, True
        elif t.kind == "scalar":
            bits, sg, is_ptr = t.bits, t.signed_, False
        else:
            return None
        offset = (offset + bits - 1) // bits * bits  # natural alignment
        fields.append(CStructField(fname, bits, sg, offset, is_ptr))
        offset += bits
    if not fields:
        return None
    align = max(f.bits for f in fields)
    size = (offset + align - 1) // align * align
    return fields, size


def parse_header(
    path: str, text: Optional[str] = None, base: Optional[Header] = None
) -> Header:
    """Parse one header into the canonical declaration model.

    ``base`` seeds the type namespace with another header's typedefs —
    tbnet.h uses tbutil.h's ``tb_iobuf``/``tb_release_fn`` in its own
    signatures, so it must be parsed with tbutil.h as base.
    """

    if text is None:
        with open(path, "r") as fh:
            text = fh.read()
    header = Header(path=path)
    if base is not None:
        header.structs.update(base.structs)
        header.funcptrs.update(base.funcptrs)
        header.opaques.extend(base.opaques)
    clean = _strip_cpp(_strip_comments(text))
    # split into ';'-terminated declarations, tracking brace depth so
    # struct bodies stay one chunk
    chunks: List[Tuple[int, str]] = []
    buf: List[str] = []
    depth = 0
    line = 1
    start_line = 1
    for ch in clean:
        if not buf and ch not in " \n\t":
            start_line = line
        if ch == "\n":
            line += 1
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == ";" and depth == 0:
            chunk = "".join(buf).strip()
            if chunk:
                chunks.append((start_line, chunk))
            buf = []
        else:
            buf.append(ch)
    for start, chunk in chunks:
        norm = " ".join(chunk.split())
        m = _OPAQUE_RE.match(norm)
        if m:
            header.opaques.append(m.group("name"))
            continue
        m = _STRUCT_RE.match(norm)
        if m:
            parsed = _parse_struct_body(m.group("body"), header)
            if parsed is None:
                header.unparsed.append((start, norm))
                continue
            fields, size = parsed
            header.structs[m.group("name")] = CStruct(
                m.group("name"), fields, size, start
            )
            continue
        m = _FUNCPTR_RE.match(norm)
        if m:
            ret = parse_type(m.group("ret"), header)
            args = _parse_arglist(m.group("args"), header)
            if ret is None or args is None:
                header.unparsed.append((start, norm))
                continue
            header.funcptrs[m.group("name")] = CFuncPtr(
                m.group("name"), ret, args, start
            )
            continue
        m = _FUNC_RE.match(norm)
        if m and "typedef" not in norm:
            ret = parse_type(m.group("ret"), header)
            args = _parse_arglist(m.group("args"), header)
            if ret is None or args is None:
                header.unparsed.append((start, norm))
                continue
            header.funcs[m.group("name")] = CFunc(
                m.group("name"), ret, args, start
            )
            continue
        header.unparsed.append((start, norm))
    return header


def merge_headers(headers: List[Header]) -> Header:
    """Fold several headers into one namespace (tbnet includes tbutil)."""

    merged = Header(path="+".join(h.path for h in headers))
    for h in headers:
        merged.funcs.update(h.funcs)
        merged.funcptrs.update(h.funcptrs)
        merged.structs.update(h.structs)
        merged.opaques.extend(h.opaques)
        merged.unparsed.extend(h.unparsed)
    return merged
