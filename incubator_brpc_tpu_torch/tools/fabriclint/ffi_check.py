"""FFI signature checker — the ctypes table vs. the compiler's truth.

The port's ``native.py`` declares every ``tb_*`` entry point's
restype/argtypes by hand (``native.SIGNATURES``); the C side declares
the same functions in ``csrc/host/tbutil/tbutil.h`` and
``csrc/host/tbnet/tbnet.h``.  There
is no compiler on the seam: a drifted width, signedness, or argument
count does not fail to link — it silently truncates a 64-bit handle,
sign-extends an error code, or shifts every argument after the missing
one.  This checker parses the headers (cdecl.py) and
diffs them against the live table:

- every sigs entry must match a header declaration in name, arity,
  integer width and signedness (``ffi-missing``/``ffi-arity``/
  ``ffi-type``);
- every header function must be bound (``ffi-unbound``) — an unbound
  function is an unchecked one the next PR will bind from memory;
- callback typedefs (``tb_frame_fn``...) must match their CFUNCTYPE
  mirrors field for field (``ffi-callback``);
- shared struct layouts (``tb_tbus_hdr``, ``tb_telemetry_record``,
  ``tb_ref_view``) must match their ctypes mirrors — offsets, widths,
  signedness, total size — and ``tb_telemetry_record`` additionally
  must match the numpy dtype the telemetry drain uses
  (``NativeServerPlane._rec_dtype``), the 64-byte ABI three ways
  (``ffi-struct``).

The headers, the bound module and the plane module come from a
``Target`` (the port's own by default).
"""

from __future__ import annotations

import ast
import ctypes
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.tools.fabriclint import (
    PORT,
    Target,
    Violation,
    allowed,
    scan_annotations,
)
from incubator_brpc_tpu_torch.tools.fabriclint import cdecl
from incubator_brpc_tpu_torch.tools.fabriclint.cdecl import CType, Header

# ctypes scalar class -> (bits, signed).  Aliases (c_uint32 is c_uint on
# LP64...) collapse by class identity.
_CTYPES_SCALARS = {
    ctypes.c_int8: (8, True),
    ctypes.c_uint8: (8, False),
    ctypes.c_int16: (16, True),
    ctypes.c_uint16: (16, False),
    ctypes.c_int32: (32, True),
    ctypes.c_uint32: (32, False),
    ctypes.c_int64: (64, True),
    ctypes.c_uint64: (64, False),
    ctypes.c_int: (32, True),
    ctypes.c_uint: (32, False),
    ctypes.c_long: (64, True),
    ctypes.c_ulong: (64, False),
    ctypes.c_size_t: (64, False),
    ctypes.c_ssize_t: (64, True),
}

# C struct name -> ctypes mirror attribute of the target's native module
_STRUCT_MIRRORS = {
    "tb_tbus_hdr": "TbusHdr",
    "tb_telemetry_record": "TelemetryRecord",
    "tb_ref_view": "_Ref",
}

# header callback typedef -> (target module, attribute) of the CFUNCTYPE
# mirror: "native" is the target's native module, "plane" its plane module
_FUNCPTR_MIRRORS = {
    "tb_release_fn": ("native", "RELEASE_FN"),
    "tb_frame_fn": ("native", "FRAME_FN"),
    "tb_handoff_fn": ("native", "HANDOFF_FN"),
    "tb_closed_fn": ("native", "CLOSED_FN"),
    "tb_native_fn": ("plane", "NATIVE_METHOD_FN"),
    "tb_auth_fn": ("native", "AUTH_FN"),
}


def _is_cfunctype(t) -> bool:
    return isinstance(t, type) and issubclass(t, ctypes._CFuncPtr)


def _is_pointer(t) -> bool:
    return isinstance(t, type) and issubclass(t, ctypes._Pointer)


def _is_structure(t) -> bool:
    return isinstance(t, type) and issubclass(t, ctypes.Structure)


def _scalar_of(t) -> Optional[Tuple[int, bool]]:
    return _CTYPES_SCALARS.get(t)


def _pyname(t) -> str:
    if t is None:
        return "None"
    return getattr(t, "__name__", repr(t))


def _match(py, c: CType, merged: Header) -> Optional[str]:
    """None when the ctypes declaration can faithfully carry the C type;
    otherwise a human-readable mismatch description."""

    if c.kind == "void":
        return None if py is None else f"C void vs ctypes {_pyname(py)}"
    if py is None:
        return f"C {c} vs ctypes None (restype void)"
    if c.kind == "scalar":
        sc = _scalar_of(py)
        if sc is None:
            return f"C {c} vs non-scalar ctypes {_pyname(py)}"
        bits, signed_ = sc
        if bits != c.bits:
            return f"width: C {c} vs ctypes {_pyname(py)} ({bits} bits)"
        if signed_ != c.signed_:
            return (
                f"signedness: C {c} vs ctypes {_pyname(py)} "
                f"({'signed' if signed_ else 'unsigned'})"
            )
        return None
    # c.kind == "ptr"
    if py is ctypes.c_void_p:
        if c.pointee.startswith("fn:"):
            return (
                f"C callback {c} passed as c_void_p — layout unchecked "
                "(annotate if the cast is by design)"
            )
        if c.pointee.startswith("scalar:") or c.pointee.startswith("struct:"):
            return (
                f"C {c} vs bare c_void_p — use a typed POINTER so width "
                "and layout stay checked"
            )
        return None  # void*/char*/opaque handles travel as c_void_p
    if py is ctypes.c_char_p:
        if c.pointee in ("void", "char"):
            return None
        return f"C {c} vs c_char_p"
    if _is_cfunctype(py):
        if not c.pointee.startswith("fn:"):
            return f"C {c} vs ctypes callback {_pyname(py)}"
        tdname = c.pointee[3:]
        td = merged.funcptrs.get(tdname)
        if td is None:
            return f"unknown callback typedef {tdname}"
        return _match_cfunctype(py, td, merged)
    if _is_pointer(py):
        inner = py._type_
        if c.pointee.startswith("scalar:"):
            want = cdecl.SCALARS.get(c.pointee[7:])
            got = _scalar_of(inner)
            if got is None:
                return f"C {c} vs POINTER({_pyname(inner)})"
            if want != got:
                return (
                    f"pointee: C {c} vs POINTER({_pyname(inner)}) "
                    f"({got[0]} bits, {'signed' if got[1] else 'unsigned'})"
                )
            return None
        if c.pointee.startswith("struct:"):
            cname = c.pointee[7:]
            if not _is_structure(inner):
                return f"C {c} vs POINTER({_pyname(inner)})"
            want_attr = _STRUCT_MIRRORS.get(cname)
            if want_attr is not None and inner.__name__ != want_attr:
                return (
                    f"C {c} vs POINTER({_pyname(inner)}) — expected the "
                    f"{want_attr} mirror"
                )
            return None  # layout itself is checked once, globally
        if c.pointee == "ptr":
            if inner is ctypes.c_char_p or inner is ctypes.c_void_p:
                return None
            return f"C pointer-to-pointer vs POINTER({_pyname(inner)})"
        return f"C {c} vs POINTER({_pyname(inner)})"
    return f"C {c} vs ctypes {_pyname(py)}"


def _match_cfunctype(py, td, merged: Header) -> Optional[str]:
    """Compare a CFUNCTYPE class against a header fn-ptr typedef."""

    res = getattr(py, "_restype_", None)
    args = list(getattr(py, "_argtypes_", ()) or ())
    err = _match(res, td.ret, merged)
    if err is not None:
        return f"callback {td.name} return: {err}"
    if len(args) != len(td.args):
        return (
            f"callback {td.name} arity: C has {len(td.args)} args, "
            f"CFUNCTYPE has {len(args)}"
        )
    for i, (pa, ca) in enumerate(zip(args, td.args)):
        err = _match(pa, ca, merged)
        if err is not None:
            return f"callback {td.name} arg {i}: {err}"
    return None


def _sig_entry_lines(source: str) -> Dict[str, int]:
    """Line number of each SIGNATURES dict key in native.py."""

    out: Dict[str, int] = {}
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == "SIGNATURES":
                    if isinstance(node.value, ast.Dict):
                        for k in node.value.keys:
                            if isinstance(k, ast.Constant) and isinstance(
                                k.value, str
                            ):
                                out[k.value] = k.lineno
    return out


def _check_struct_ctypes(
    cs: cdecl.CStruct, mirror, path: str
) -> List[Violation]:
    out: List[Violation] = []
    pyfields = getattr(mirror, "_fields_", [])
    if len(pyfields) != len(cs.fields):
        out.append(
            Violation(
                "ffi-struct", path, cs.line,
                f"{cs.name}: C has {len(cs.fields)} fields, "
                f"{mirror.__name__} has {len(pyfields)}",
            )
        )
        return out
    for cf, (pyname, pytype) in zip(cs.fields, pyfields):
        desc = getattr(mirror, pyname)
        if pyname != cf.name:
            out.append(
                Violation(
                    "ffi-struct", path, cs.line,
                    f"{cs.name}.{cf.name}: mirror field is named {pyname}",
                )
            )
            continue
        if cf.is_ptr:
            ok = pytype in (ctypes.c_void_p, ctypes.c_char_p) or _is_pointer(
                pytype
            )
            if not ok:
                out.append(
                    Violation(
                        "ffi-struct", path, cs.line,
                        f"{cs.name}.{cf.name}: C pointer vs "
                        f"{_pyname(pytype)}",
                    )
                )
                continue
        else:
            sc = _scalar_of(pytype)
            if sc is None or sc != (cf.bits, cf.signed_):
                out.append(
                    Violation(
                        "ffi-struct", path, cs.line,
                        f"{cs.name}.{cf.name}: C "
                        f"{'i' if cf.signed_ else 'u'}{cf.bits} vs "
                        f"{_pyname(pytype)}",
                    )
                )
                continue
        if desc.offset * 8 != cf.offset_bits or desc.size * 8 != cf.bits:
            out.append(
                Violation(
                    "ffi-struct", path, cs.line,
                    f"{cs.name}.{cf.name}: offset/size "
                    f"{desc.offset}/{desc.size} bytes vs C "
                    f"{cf.offset_bits // 8}/{cf.bits // 8}",
                )
            )
    if ctypes.sizeof(mirror) * 8 != cs.size_bits:
        out.append(
            Violation(
                "ffi-struct", path, cs.line,
                f"{cs.name}: sizeof mismatch — C {cs.size_bits // 8} "
                f"bytes, ctypes {ctypes.sizeof(mirror)}",
            )
        )
    return out


def _check_telemetry_dtype(
    cs: cdecl.CStruct, path: str, target: Target
) -> List[Violation]:
    """The numpy structured dtype the drain overlays on the batch buffer
    is a THIRD copy of the record ABI — check it against the header too."""

    out: List[Violation] = []
    dt = target.plane().NativeServerPlane._rec_dtype()
    if dt.itemsize * 8 != cs.size_bits:
        out.append(
            Violation(
                "ffi-struct", path, cs.line,
                f"{cs.name}: numpy dtype itemsize {dt.itemsize} vs C "
                f"{cs.size_bits // 8} bytes",
            )
        )
    names = list(dt.names or ())
    if names != [f.name for f in cs.fields]:
        out.append(
            Violation(
                "ffi-struct", path, cs.line,
                f"{cs.name}: numpy dtype fields {names} vs C "
                f"{[f.name for f in cs.fields]}",
            )
        )
        return out
    for cf in cs.fields:
        sub, offset = dt.fields[cf.name][:2]
        if (
            offset * 8 != cf.offset_bits
            or sub.itemsize * 8 != cf.bits
            or sub.kind != ("i" if cf.signed_ else "u")
            or sub.byteorder not in ("<", "=", "|")
        ):
            out.append(
                Violation(
                    "ffi-struct", path, cs.line,
                    f"{cs.name}.{cf.name}: numpy {sub.str}@{offset} vs C "
                    f"{'i' if cf.signed_ else 'u'}{cf.bits}"
                    f"@{cf.offset_bits // 8}",
                )
            )
    return out


def parse_repo_headers(
    tbutil_text: Optional[str] = None,
    tbnet_text: Optional[str] = None,
    target: Target = PORT,
) -> Header:
    tbutil_h, tbnet_h = target.headers
    tu = cdecl.parse_header(tbutil_h, text=tbutil_text)
    tn = cdecl.parse_header(tbnet_h, text=tbnet_text, base=tu)
    return cdecl.merge_headers([tu, tn])


def check(
    tbutil_text: Optional[str] = None,
    tbnet_text: Optional[str] = None,
    signatures: Optional[dict] = None,
    target: Target = PORT,
) -> List[Violation]:
    """Cross-check SIGNATURES against the headers.  The text/signature
    injection points exist for the meta-tests (seeded mutations must
    flip the checker red)."""

    native = target.native()
    TBUTIL_H, TBNET_H = target.headers
    NATIVE_PY = native.__file__

    tbutil_hdr = cdecl.parse_header(TBUTIL_H, text=tbutil_text)
    tbnet_hdr = cdecl.parse_header(TBNET_H, text=tbnet_text, base=tbutil_hdr)
    merged = cdecl.merge_headers([tbutil_hdr, tbnet_hdr])
    sigs = native.SIGNATURES if signatures is None else signatures
    with open(NATIVE_PY, "r") as fh:
        native_src = fh.read()
    sig_lines = _sig_entry_lines(native_src)
    native_ann = scan_annotations(NATIVE_PY, native_src)
    header_anns = {
        TBUTIL_H: scan_annotations(TBUTIL_H, tbutil_text),
        TBNET_H: scan_annotations(TBNET_H, tbnet_text),
    }
    out: List[Violation] = list(native_ann.bad)
    for ann in header_anns.values():
        out.extend(ann.bad)

    def _hdr_allowed(rule: str, line: int, path: str) -> bool:
        ann = header_anns.get(path)
        return ann is not None and allowed(ann, rule, line)

    for hdr, path in ((tbutil_hdr, TBUTIL_H), (tbnet_hdr, TBNET_H)):
        for line, decl in hdr.unparsed:
            out.append(
                Violation(
                    "ffi-parse", path, line,
                    f"declaration not modeled by the checker: {decl[:80]}",
                )
            )

    for name, (restype, argtypes) in sigs.items():
        line = sig_lines.get(name, 1)
        cf = merged.funcs.get(name)
        if cf is None:
            if not allowed(native_ann, "ffi-missing", line):
                out.append(
                    Violation(
                        "ffi-missing", NATIVE_PY, line,
                        f"{name} is declared in SIGNATURES but not in any "
                        "header",
                    )
                )
            continue
        err = _match(restype, cf.ret, merged)
        if err is not None:
            rule = "ffi-callback" if "callback" in err else "ffi-type"
            if not allowed(native_ann, rule, line):
                out.append(
                    Violation(rule, NATIVE_PY, line, f"{name} return: {err}")
                )
        if len(argtypes) != len(cf.args):
            if not allowed(native_ann, "ffi-arity", line):
                out.append(
                    Violation(
                        "ffi-arity", NATIVE_PY, line,
                        f"{name}: C has {len(cf.args)} args, SIGNATURES "
                        f"has {len(argtypes)}",
                    )
                )
            continue
        for i, (pa, ca) in enumerate(zip(argtypes, cf.args)):
            err = _match(pa, ca, merged)
            if err is not None:
                rule = (
                    "ffi-callback"
                    if "callback" in err or ca.pointee.startswith("fn:")
                    else "ffi-type"
                )
                if not allowed(native_ann, rule, line):
                    out.append(
                        Violation(
                            rule, NATIVE_PY, line, f"{name} arg {i}: {err}"
                        )
                    )

    for name, cf in merged.funcs.items():
        if name not in sigs:
            src_path = TBUTIL_H if name in tbutil_hdr.funcs else TBNET_H
            if not _hdr_allowed("ffi-unbound", cf.line, src_path):
                out.append(
                    Violation(
                        "ffi-unbound", src_path, cf.line,
                        f"{name} is exported by the header but has no "
                        "SIGNATURES entry",
                    )
                )

    # callback typedef layouts (checked globally, not only at use sites)
    for tdname, (mod, attr) in _FUNCPTR_MIRRORS.items():
        td = merged.funcptrs.get(tdname)
        if td is None:
            out.append(
                Violation(
                    "ffi-callback", TBNET_H, 1,
                    f"callback typedef {tdname} not found in headers",
                )
            )
            continue
        owner = target.native() if mod == "native" else target.plane()
        py = getattr(owner, attr)
        err = _match_cfunctype(py, td, merged)
        if err is not None:
            out.append(
                Violation(
                    "ffi-callback", TBNET_H, td.line, f"{attr}: {err}"
                )
            )

    # struct layouts: header vs ctypes mirror (and numpy for telemetry)
    for cname, attr in _STRUCT_MIRRORS.items():
        cs = merged.structs.get(cname)
        if cs is None:
            out.append(
                Violation(
                    "ffi-struct", TBNET_H, 1,
                    f"struct {cname} not found in headers",
                )
            )
            continue
        mirror = getattr(native, attr)
        src_path = TBUTIL_H if cname in tbutil_hdr.structs else TBNET_H
        out.extend(_check_struct_ctypes(cs, mirror, src_path))
        if cname == "tb_telemetry_record":
            out.extend(_check_telemetry_dtype(cs, src_path, target))
    return out
