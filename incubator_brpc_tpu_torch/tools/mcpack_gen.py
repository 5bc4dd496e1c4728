#!/usr/bin/env python
"""mcpack_gen — ahead-of-time codec generator for mcpack Message schemas
(the reference's mcpack2pb protoc plugin role:
src/mcpack2pb/generator.cpp emits C++ parse/serialize for
proto messages; here the schema source is a Python module of ``Message``
subclasses and the emitted artifact is a Python module of UNROLLED
``pack_<Name>`` / ``unpack_<Name>`` functions — no spec walk, no isinstance
ladder, no dict staging on the serialize path).

Usage:
    python -m incubator_brpc_tpu_torch.tools.mcpack_gen path/to/schemas.py -o schemas_mcpack.py

The generated bytes are IDENTICAL to the runtime bridge's
(``message_to_mcpack``) — the generator test asserts byte equality — so
generated and reflective peers interoperate freely; AOT buys speed and an
auditable artifact, exactly the trade the reference plugin makes.

The port's copy of the JAX package's ``tools/mcpack_gen.py``: the modules
it writes import the port's ``protocol/mcpack.py`` and ``json2pb.py``, and
pack the same bytes as the port's ``message_to_mcpack``.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from typing import List


def _message_base():
    from incubator_brpc_tpu_torch.protocol.json2pb import Message

    return Message


HEADER = '''"""GENERATED by incubator_brpc_tpu_torch.tools.mcpack_gen — do not edit.

Unrolled mcpack codecs for the Message schemas of {src!r}. Byte-identical
to the runtime bridge (message_to_mcpack / message_from_mcpack); emitted
ahead of time so the hot path runs straight-line code (the mcpack2pb
generator role).
"""

import struct

from incubator_brpc_tpu_torch.protocol.json2pb import Message  # noqa: F401
from incubator_brpc_tpu_torch.protocol.mcpack import (
    BINARY,
    BOOL,
    DOUBLE,
    INT32,
    INT64,
    NULL,
    OBJECT,
    ARRAY,
    ParseError,
    STRING,
    UINT64,
    _emit_fixed,
    _emit_sized,
    loads,
)

_MISSING = object()  # absent-field sentinel (a wire NULL decodes to None)

_I32 = struct.Struct("<i").pack
_I64 = struct.Struct("<q").pack
_U64 = struct.Struct("<Q").pack
_F64 = struct.Struct("<d").pack
_U32 = struct.Struct("<I").pack


def _emit_int(out, nb, v):
    if -2147483648 <= v < 2147483648:
        _emit_fixed(out, INT32, nb, _I32(v))
    elif -9223372036854775808 <= v < 9223372036854775808:
        _emit_fixed(out, INT64, nb, _I64(v))
    elif 0 <= v < 18446744073709551616:
        _emit_fixed(out, UINT64, nb, _U64(v))
    else:
        raise ValueError(f"integer {{v}} out of 64-bit range")


def _wrap_obj(out, nb, body, count):
    body = _U32(count) + bytes(body)
    out += struct.pack("<BBI", OBJECT, len(nb), len(body))
    out += nb
    out += body


def _wrap_arr(out, nb, body, count):
    body = _U32(count) + bytes(body)
    out += struct.pack("<BBI", ARRAY, len(nb), len(body))
    out += nb
    out += body
'''


def _scalar_emit(kind, nb_expr: str, v_expr: str, out: str) -> str:
    """One unrolled emit statement for a present scalar value."""
    if kind is bool:
        return (
            f"_emit_fixed({out}, BOOL, {nb_expr}, "
            f"b'\\x01' if {v_expr} else b'\\x00')"
        )
    if kind is int:
        return f"_emit_int({out}, {nb_expr}, {v_expr})"
    if kind is float:
        return f"_emit_fixed({out}, DOUBLE, {nb_expr}, _F64({v_expr}))"
    if kind is str:
        return (
            f"_emit_sized({out}, STRING, {nb_expr}, "
            f"{v_expr}.encode() + b'\\x00')"
        )
    if kind is bytes:
        return f"_emit_sized({out}, BINARY, {nb_expr}, bytes({v_expr}))"
    raise TypeError(f"unsupported scalar kind {kind!r}")


def _coerce_lines(spec, v_expr: str, indent: str) -> List[str]:
    """Unrolled type-check/coercion for one decoded value."""
    Message = _message_base()
    kind = spec.kind
    n = spec.name
    if isinstance(kind, type) and issubclass(kind, Message):
        return [
            f"{indent}if not isinstance({v_expr}, dict):",
            f"{indent}    raise ParseError('field {n}: expected object')",
            f"{indent}{v_expr} = _from_dict_{kind.__name__}({v_expr})",
        ]
    if kind is float:
        return [
            f"{indent}if isinstance({v_expr}, bool) or not "
            f"isinstance({v_expr}, (int, float)):",
            f"{indent}    raise ParseError('field {n}: expected number')",
            f"{indent}{v_expr} = float({v_expr})",
        ]
    if kind is int:
        return [
            f"{indent}if isinstance({v_expr}, bool) or not "
            f"isinstance({v_expr}, int):",
            f"{indent}    raise ParseError('field {n}: expected int')",
        ]
    if kind is bytes:
        return [
            f"{indent}if not isinstance({v_expr}, (bytes, bytearray)):",
            f"{indent}    raise ParseError('field {n}: expected binary')",
            f"{indent}{v_expr} = bytes({v_expr})",
        ]
    tname = kind.__name__
    return [
        f"{indent}if not isinstance({v_expr}, {tname}):",
        f"{indent}    raise ParseError('field {n}: expected {tname}')",
    ]


def _gen_body_fn(cls) -> List[str]:
    """_body_<Name>(msg) -> (bytearray, present_count): the OBJECT body
    with every present field emitted in declaration order."""
    name = cls.__name__
    Message = _message_base()
    lines = [f"def _body_{name}(msg):", "    body = bytearray()", "    n = 0"]
    for spec in cls._specs.values():
        nb = spec.name.encode() + b"\x00"
        nb_expr = repr(nb)
        lines.append(f"    v = msg.{spec.name}")
        lines.append("    if v is not None:")
        lines.append("        n += 1")
        kind = spec.kind
        nested = isinstance(kind, type) and issubclass(kind, Message)
        if spec.repeated:
            lines.append("        items = bytearray()")
            lines.append("        for item in v:")
            if nested:
                lines.append(
                    f"            ib, ic = _body_{kind.__name__}(item)"
                )
                lines.append("            _wrap_obj(items, b'', ib, ic)")
            else:
                lines.append(
                    "            "
                    + _scalar_emit(kind, "b''", "item", "items")
                )
            lines.append(f"        _wrap_arr(body, {nb_expr}, items, len(v))")
        elif nested:
            lines.append(f"        ib, ic = _body_{kind.__name__}(v)")
            lines.append(f"        _wrap_obj(body, {nb_expr}, ib, ic)")
        else:
            lines.append(
                "        " + _scalar_emit(kind, nb_expr, "v", "body")
            )
    lines.append("    return body, n")
    return lines


def _gen_pack_fn(cls) -> List[str]:
    name = cls.__name__
    return [
        f"def pack_{name}(msg):",
        f'    """Serialize a {name} — byte-identical to message_to_mcpack.'
        '"""',
        f"    body, n = _body_{name}(msg)",
        "    out = bytearray()",
        "    _wrap_obj(out, b'', body, n)",
        "    return bytes(out)",
    ]


def _gen_from_dict_fn(cls) -> List[str]:
    name = cls.__name__
    lines = [f"def _from_dict_{name}(obj):", f"    m = {name}()"]
    for spec in cls._specs.values():
        # absent fields keep their default; a PRESENT NULL is a type
        # error, exactly like the runtime bridge (message_from_mcpack
        # coerces whatever value is present, and None fails the check)
        lines.append(f"    v = obj.get({spec.name!r}, _MISSING)")
        lines.append("    if v is not _MISSING:")
        lines.append("        if v is None:")
        lines.append(
            f"            raise ParseError('field {spec.name}: "
            "null where value expected')"
        )
        if spec.repeated:
            lines.append("        if not isinstance(v, list):")
            lines.append(
                f"            raise ParseError('field {spec.name}: "
                "expected array')"
            )
            lines.append("        out = []")
            lines.append("        for item in v:")
            lines.extend(_coerce_lines(spec, "item", "            "))
            lines.append("            out.append(item)")
            lines.append("        v = out")
        else:
            lines.extend(_coerce_lines(spec, "v", "        "))
        lines.append(f"        m.{spec.name} = v")
    lines.append("    return m")
    return lines


def _gen_unpack_fn(cls) -> List[str]:
    name = cls.__name__
    return [
        f"def unpack_{name}(data):",
        f'    """Parse mcpack bytes into a {name} (message_from_mcpack '
        'contract)."""',
        "    obj = loads(data)",
        "    if not isinstance(obj, dict):",
        "        raise ParseError('mcpack top-level value is not an object')",
        f"    return _from_dict_{name}(obj)",
    ]


def _message_classes(module) -> List[type]:
    """Every Message subclass the module's schemas reach: those defined in
    the module PLUS any Message types its fields reference from other
    modules (a generated _body_X must exist for every nested field, or
    pack would NameError at runtime). Ordered nested-dependency-first."""
    Message = _message_base()
    found = [
        v
        for v in vars(module).values()
        if isinstance(v, type)
        and issubclass(v, Message)
        and v is not Message
        and v.__module__ == module.__name__
    ]
    ordered: List[type] = []
    seen = set()

    def visit(cls):
        if cls in seen:
            return
        seen.add(cls)
        for spec in cls._specs.values():
            k = spec.kind
            if isinstance(k, type) and issubclass(k, Message):
                visit(k)  # cross-module field types generate too
        ordered.append(cls)

    for cls in found:
        visit(cls)
    return ordered


def generate(module, src_name: str = "") -> str:
    """Emit the codec module source for every Message subclass in
    ``module``."""
    classes = _message_classes(module)
    if not classes:
        raise SystemExit("no Message subclasses found in the schema module")
    parts = [HEADER.format(src=src_name or module.__name__)]
    by_module: dict = {}
    for c in classes:
        by_module.setdefault(c.__module__, []).append(c.__name__)
    for mod in sorted(by_module):
        parts.append(
            "from " + mod + " import " + ", ".join(sorted(by_module[mod]))
            + "\n"
        )
    for cls in classes:
        parts.append("\n".join(_gen_body_fn(cls)) + "\n")
        parts.append("\n".join(_gen_pack_fn(cls)) + "\n")
        parts.append("\n".join(_gen_from_dict_fn(cls)) + "\n")
        parts.append("\n".join(_gen_unpack_fn(cls)) + "\n")
    parts.append(
        "CODECS = {\n"
        + "".join(
            f"    {c.__name__!r}: (pack_{c.__name__}, unpack_{c.__name__}),\n"
            for c in classes
        )
        + "}\n"
    )
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("schema", help="python module file defining Messages")
    ap.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("_mcpack_schema", args.schema)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    src = generate(module, src_name=args.schema)
    # the generated module imports the schema classes: rewrite the loader's
    # temporary module name to the schema file's stem so the output is
    # importable next to the schema file
    import os as _os

    stem = _os.path.splitext(_os.path.basename(args.schema))[0]
    src = src.replace("from _mcpack_schema import", f"from {stem} import")
    with open(args.out, "w") as f:
        f.write(src)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
