"""mcpack (``protocol/mcpack.py``) and its generator
(``tools/mcpack_gen.py``) of the port on the CPU, held against the JAX
package's:

- ``tests/test_mcpack.py``'s 26 cases on both packages (the hand-assembled
  wire fixtures, the codec's refusals, the ``Message`` bridge, nshead+mcpack
  served end to end, and the ahead-of-time generator, each package's
  generator writing a module over its own ``mcpack``);
- the bytes across the packages: one seeded set of values (every field
  type, both head sizes, nesting) dumps to identical bytes in both
  packages and each package loads the other's bytes to the same value; the
  same holds for ``Message`` objects through ``message_to_mcpack`` and
  through both generators' ``pack_`` functions.

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes or values."""

from __future__ import annotations

import importlib.util
import socket as pysock
import struct
import sys
import threading
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
import tools.mcpack_gen as jax_gen
from incubator_brpc_tpu.protocol import json2pb as jax_json2pb
from incubator_brpc_tpu.protocol import mcpack as jax_mcpack
from incubator_brpc_tpu.protocol import nshead as jax_nshead
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu_torch.protocol import json2pb as port_json2pb
from incubator_brpc_tpu_torch.protocol import mcpack as port_mcpack
from incubator_brpc_tpu_torch.protocol import nshead as port_nshead
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.tools import mcpack_gen as port_gen


def _schema(json2pb):
    """tests/test_mcpack.py's Inner and Req over one package's Message."""
    Message, field = json2pb.Message, json2pb.field

    class Inner(Message):
        tag = field(1, str)

    class Req(Message):
        name = field(1, str)
        count = field(2, int)
        ratio = field(3, float)
        blob = field(4, bytes)
        inner = field(5, Inner)
        values = field(6, int, repeated=True)

    return types.SimpleNamespace(Inner=Inner, Req=Req)


PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", mcpack=jax_mcpack, json2pb=jax_json2pb, nshead=jax_nshead, rpc=jax_rpc,
        ParseError=jax_tbus.ParseError, gen=jax_gen, json2pb_path="incubator_brpc_tpu",
        schema=_schema(jax_json2pb), server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", mcpack=port_mcpack, json2pb=port_json2pb, nshead=port_nshead,
        rpc=port_rpc, ParseError=port_tbus.ParseError, gen=port_gen,
        json2pb_path="incubator_brpc_tpu_torch", schema=_schema(port_json2pb),
        server_kw={"device": "cpu"},
    ),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def obj_frame(*items: bytes, name: bytes = b"") -> bytes:
    """Hand-build | FieldLongHead | name | ItemsHead | items |."""
    body = struct.pack("<I", len(items)) + b"".join(items)
    return struct.pack("<BBI", 0x10, len(name), len(body)) + name + body


# -- tests/test_mcpack.py on both packages -----------------------------------


class TestWireFixtures:
    def test_int32_field_bytes(self, pkg):
        # {"a": 1}: OBJECT long head, then INT32 fixed head:
        # | 0x14 | name_size=2 | "a\0" | 01 00 00 00 |
        item = bytes([0x14, 2]) + b"a\x00" + struct.pack("<i", 1)
        frame = obj_frame(item)
        assert pkg.mcpack.loads(frame) == {"a": 1}
        assert pkg.mcpack.dumps({"a": 1}) == frame  # byte-exact emit

    def test_short_string_field_bytes(self, pkg):
        # "s": "hi" → short head: | 0x50|0x80 | name=2 | value=3 | s\0 hi\0
        item = bytes([0xD0, 2, 3]) + b"s\x00" + b"hi\x00"
        frame = obj_frame(item)
        assert pkg.mcpack.loads(frame) == {"s": "hi"}
        assert pkg.mcpack.dumps({"s": "hi"}) == frame

    def test_long_string_uses_long_head(self, pkg):
        s = "x" * 300  # 301 incl NUL > 255 → FieldLongHead
        data = pkg.mcpack.dumps({"s": s})
        # top head(6) + items(4) + field head: type without short mask
        assert data[10] == 0x50
        assert pkg.mcpack.loads(data) == {"s": s}

    def test_binary_field_bytes(self, pkg):
        item = bytes([0xE0, 2, 4]) + b"b\x00" + b"\x00\x01\x02\xff"
        frame = obj_frame(item)
        assert pkg.mcpack.loads(frame) == {"b": b"\x00\x01\x02\xff"}
        assert pkg.mcpack.dumps({"b": b"\x00\x01\x02\xff"}) == frame

    def test_bool_null_double(self, pkg):
        items = [
            bytes([0x31, 2]) + b"t\x00" + b"\x01",
            bytes([0x61, 2]) + b"n\x00" + b"\x00",
            bytes([0x48, 2]) + b"d\x00" + struct.pack("<d", 2.5),
        ]
        frame = obj_frame(*items)
        assert pkg.mcpack.loads(frame) == {"t": True, "n": None, "d": 2.5}

    def test_nested_object_and_array(self, pkg):
        value = {"outer": {"inner": [1, "two", None]}}
        assert pkg.mcpack.loads(pkg.mcpack.dumps(value)) == value

    def test_isoarray_parses(self, pkg):
        # iso array of int32 [1,2,3]: long head ISOARRAY, value =
        # | item_type=0x14 | 3 packed int32 |
        body = bytes([0x14]) + struct.pack("<iii", 1, 2, 3)
        item = struct.pack("<BBI", 0x30, 2, len(body)) + b"v\x00" + body
        frame = obj_frame(item)
        assert pkg.mcpack.loads(frame) == {"v": [1, 2, 3]}

    def test_deleted_field_skipped(self, pkg):
        # type 0x0F: & 0x70 == 0 → deleted; value_size = low nibble (15)
        deleted = bytes([0x0F, 2]) + b"x\x00" + b"\xaa" * 15
        keep = bytes([0x14, 2]) + b"k\x00" + struct.pack("<i", 7)
        frame = obj_frame(deleted, keep)
        assert pkg.mcpack.loads(frame) == {"k": 7}

    def test_int_width_selection(self, pkg):
        small = pkg.mcpack.dumps({"v": 1})
        big = pkg.mcpack.dumps({"v": 1 << 40})
        huge = pkg.mcpack.dumps({"v": (1 << 63) + 1})
        assert small[10] == 0x14  # INT32
        assert big[10] == 0x18  # INT64
        assert huge[10] == 0x28  # UINT64
        for frame, expect in ((small, 1), (big, 1 << 40), (huge, (1 << 63) + 1)):
            assert pkg.mcpack.loads(frame) == {"v": expect}


class TestRobustness:
    def test_truncated_raises(self, pkg):
        data = pkg.mcpack.dumps({"a": 1, "s": "hello"})
        for cut in (1, 5, len(data) - 1):
            with pytest.raises(pkg.ParseError):
                pkg.mcpack.loads(data[:cut])

    def test_bad_string_termination(self, pkg):
        item = bytes([0xD0, 2, 2]) + b"s\x00" + b"hi"  # no NUL
        with pytest.raises(pkg.ParseError):
            pkg.mcpack.loads(obj_frame(item))

    def test_name_missing_nul_rejected(self, pkg):
        # name_size counts the NUL (field_type.h note); 'a' without it must
        # raise, not silently become the empty name
        item = bytes([0x14, 1]) + b"a" + struct.pack("<i", 1)
        with pytest.raises(pkg.ParseError):
            pkg.mcpack.loads(obj_frame(item))

    def test_non_utf8_name_and_string_raise_parse_error(self, pkg):
        item = bytes([0x14, 3]) + b"\xff\xfe\x00" + struct.pack("<i", 1)
        with pytest.raises(pkg.ParseError):
            pkg.mcpack.loads(obj_frame(item))
        sval = bytes([0xD0, 2, 3]) + b"s\x00" + b"\xff\xfe\x00"
        with pytest.raises(pkg.ParseError):
            pkg.mcpack.loads(obj_frame(sval))

    def test_depth_bomb_rejected(self, pkg):
        v = {}
        for _ in range(200):
            v = {"d": v}
        with pytest.raises(ValueError):
            pkg.mcpack.dumps(v)

    def test_isoarray_ragged_rejected(self, pkg):
        body = bytes([0x14]) + b"\x01\x02\x03"  # 3 bytes, not /4
        item = struct.pack("<BBI", 0x30, 0, len(body)) + body
        with pytest.raises(pkg.ParseError):
            pkg.mcpack.loads(obj_frame(item))

    def test_value_roundtrip_all_kinds(self, pkg):
        value = {
            "i": -5,
            "big": 1 << 50,
            "f": 3.25,
            "t": True,
            "s": "héllo",
            "b": b"\x00raw",
            "n": None,
            "arr": [1, [2, 3], {"k": "v"}],
            "obj": {"nested": {"deep": 1}},
        }
        assert pkg.mcpack.loads(pkg.mcpack.dumps(value)) == value


class TestSchemaBridge:
    def test_message_roundtrip(self, pkg):
        Req, Inner = pkg.schema.Req, pkg.schema.Inner
        msg = Req(name="n", count=12, ratio=0.5, blob=b"bb", inner=Inner(tag="t"),
                  values=[1, 2, 3])
        data = pkg.mcpack.message_to_mcpack(msg)
        back = pkg.mcpack.message_from_mcpack(Req, data)
        assert back == msg

    def test_same_schema_serves_proto2_and_mcpack(self, pkg):
        """The mcpack2pb promise: ONE typed message, two wire formats."""
        Req = pkg.schema.Req
        msg = Req(name="dual", count=3)
        pb = Req.from_binary(msg.to_binary())
        mc = pkg.mcpack.message_from_mcpack(Req, pkg.mcpack.message_to_mcpack(msg))
        assert pb == mc == msg

    def test_int_coerces_to_float_field(self, pkg):
        data = pkg.mcpack.dumps({"ratio": 2})
        msg = pkg.mcpack.message_from_mcpack(pkg.schema.Req, data)
        assert msg.ratio == 2.0

    def test_type_mismatch_raises(self, pkg):
        data = pkg.mcpack.dumps({"count": "not-an-int"})
        with pytest.raises(pkg.ParseError):
            pkg.mcpack.message_from_mcpack(pkg.schema.Req, data)


def _read_nshead(pkg, conn) -> bytes:
    resp = b""
    while True:
        chunk = conn.recv(65536)
        if not chunk:
            break
        resp += chunk
        total = pkg.nshead.parse_header(resp[: pkg.nshead.HEADER_BYTES])
        if total is not None and len(resp) >= total:
            break
    return resp


class TestNsheadMcpackService:
    def test_end_to_end_over_nshead(self, pkg):
        """nshead+mcpack loopback: the reference's NsheadMcpackAdaptor
        shape — typed dict in, typed dict out, nshead framing outside."""

        def handler(cntl, req: dict) -> dict:
            return {"echo": req.get("msg", ""), "n": req.get("n", 0) + 1}

        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(
            usercode_inline=True, nshead_service=pkg.mcpack.make_mcpack_service(handler),
            **pkg.server_kw))
        assert srv.start(0)
        try:
            body = pkg.mcpack.dumps({"msg": "hi", "n": 41})
            conn = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
            conn.sendall(pkg.nshead.pack_frame(body, log_id=7))
            frame, _ = pkg.nshead.try_parse_frame(_read_nshead(pkg, conn))
            assert frame is not None
            assert pkg.mcpack.loads(frame.payload) == {"echo": "hi", "n": 42}
            conn.close()
        finally:
            srv.stop()
            srv.join(timeout=10)


SCHEMA = '''
from {json2pb}.protocol.json2pb import Message, field


class Inner(Message):
    tag = field(1, str)
    weight = field(2, float)


class Outer(Message):
    name = field(1, str)
    count = field(2, int)
    ratio = field(3, float)
    ok = field(4, bool)
    blob = field(5, bytes)
    inner = field(6, Inner)
    labels = field(7, str, repeated=True)
    inners = field(8, Inner, repeated=True)
'''


def build_generated(pkg, tmp_path):
    """The schema module over ``pkg``'s Message and the module ``pkg``'s own
    generator writes for it (each package's under a name of its own)."""
    name = f"gen_schema_{pkg.name}"
    schema_path = tmp_path / f"{name}.py"
    schema_path.write_text(SCHEMA.format(json2pb=pkg.json2pb_path))
    spec = importlib.util.spec_from_file_location(name, schema_path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    src = pkg.gen.generate(module, src_name=f"{name}.py")
    # the generated module reads the generating package's mcpack
    assert f"from {pkg.json2pb_path}.protocol.mcpack import" in src
    ns = {}
    exec(compile(src, "<generated>", "exec"), ns)
    return module, ns


def generator_samples(module):
    Inner, Outer = module.Inner, module.Outer
    yield Outer()
    yield Outer(name="x")
    yield Outer(
        name="full", count=42, ratio=2.5, ok=True, blob=b"\x00\xff",
        inner=Inner(tag="t", weight=0.25),
        labels=["a", "b", ""],
        inners=[Inner(tag="i1"), Inner(weight=9.0)],
    )
    yield Outer(count=-(2**40), ok=False)  # int64 path
    yield Outer(count=2**63 + 5)  # uint64 path
    yield Outer(name="s" * 300, blob=b"B" * 300)  # long heads


class TestAotGenerator:
    """tools/mcpack_gen.py — the mcpack2pb protoc-plugin analog. Contract:
    generated bytes are IDENTICAL to the runtime bridge's, so generated and
    reflective peers interoperate."""

    def test_generated_bytes_match_runtime_bridge(self, pkg, tmp_path):
        module, ns = build_generated(pkg, tmp_path)
        for msg in generator_samples(module):
            assert ns["pack_Outer"](msg) == pkg.mcpack.message_to_mcpack(msg)

    def test_generated_roundtrip_and_cross_decode(self, pkg, tmp_path):
        module, ns = build_generated(pkg, tmp_path)
        for msg in generator_samples(module):
            wire = ns["pack_Outer"](msg)
            back = ns["unpack_Outer"](wire)
            back2 = pkg.mcpack.message_from_mcpack(module.Outer, wire)
            back3 = ns["unpack_Outer"](pkg.mcpack.message_to_mcpack(msg))
            for m in (back, back2, back3):
                for spec in module.Outer._specs.values():
                    got, want = getattr(m, spec.name), getattr(msg, spec.name)
                    if isinstance(want, list) and want and hasattr(want[0], "_specs"):
                        assert [i.tag for i in got] == [i.tag for i in want]
                    elif hasattr(want, "_specs"):
                        assert got.tag == want.tag and got.weight == want.weight
                    else:
                        assert got == want, spec.name

    def test_present_null_rejected_like_runtime(self, pkg, tmp_path):
        module, ns = build_generated(pkg, tmp_path)
        wire = pkg.mcpack.dumps({"count": None})  # present NULL field
        with pytest.raises(pkg.ParseError):
            pkg.mcpack.message_from_mcpack(module.Outer, wire)
        with pytest.raises(pkg.ParseError):  # generated must agree
            ns["unpack_Outer"](wire)

    def test_out_of_range_int_raises_valueerror(self, pkg, tmp_path):
        module, ns = build_generated(pkg, tmp_path)
        with pytest.raises(ValueError):
            ns["pack_Outer"](module.Outer(count=-(2**63) - 1))
        with pytest.raises(ValueError):
            ns["pack_Outer"](module.Outer(count=2**64))

    def test_generated_unpack_rejects_bad_types(self, pkg, tmp_path):
        _module, ns = build_generated(pkg, tmp_path)
        with pytest.raises(pkg.ParseError):
            ns["unpack_Outer"](pkg.mcpack.dumps({"count": "not-an-int"}))
        with pytest.raises(pkg.ParseError):
            ns["unpack_Outer"](pkg.mcpack.dumps({"inner": "not-an-object"}))
        with pytest.raises(pkg.ParseError):
            ns["unpack_Outer"](pkg.mcpack.dumps({"labels": "not-an-array"}))


# -- the bytes across the packages -----------------------------------------


def seeded_value(rng, depth=0):
    """One dict of every kind mcpack dumps: ints of each width, doubles,
    bools, None, short and long strings and binaries, lists and nesting."""
    out = {}
    for i in range(int(rng.integers(3, 9))):
        kind = int(rng.integers(0, 10 if depth < 3 else 8))
        key = f"k{i}_{kind}"
        if kind == 0:
            out[key] = int(rng.integers(-(1 << 31), 1 << 31))
        elif kind == 1:
            out[key] = int(rng.integers(1 << 31, 1 << 62)) * int(rng.choice([-1, 1]))
        elif kind == 2:
            out[key] = (1 << 63) + int(rng.integers(0, 1 << 62))
        elif kind == 3:
            out[key] = float(rng.standard_normal())
        elif kind == 4:
            out[key] = bool(rng.integers(0, 2))
        elif kind == 5:
            out[key] = None
        elif kind == 6:
            n = int(rng.choice([0, 5, 253, 254, 600]))
            out[key] = "".join(chr(c) for c in rng.integers(0x20, 0x250, n))
        elif kind == 7:
            out[key] = rng.integers(0, 256, int(rng.choice([0, 7, 255, 256, 1000])),
                                    dtype=np.uint8).tobytes()
        elif kind == 8:
            out[key] = seeded_value(rng, depth + 1)
        else:
            out[key] = [int(rng.integers(-9, 9)), "s", seeded_value(rng, depth + 1), None]
    return out


def test_dumps_bytes_identical_across_packages():
    rng = np.random.default_rng(27)
    for _ in range(40):
        value = seeded_value(rng)
        jax_bytes = jax_mcpack.dumps(value)
        port_bytes = port_mcpack.dumps(value)
        assert port_bytes == jax_bytes
        assert port_mcpack.loads(jax_bytes) == jax_mcpack.loads(port_bytes) == value


def test_message_and_generated_bytes_identical_across_packages(tmp_path):
    jax_req = PKGS["jax"].schema.Req(name="n", count=-7, ratio=0.125, blob=b"\x00\x01",
                                     inner=PKGS["jax"].schema.Inner(tag="t"), values=[3, 1 << 40])
    port_req = PKGS["torch"].schema.Req(name="n", count=-7, ratio=0.125, blob=b"\x00\x01",
                                        inner=PKGS["torch"].schema.Inner(tag="t"),
                                        values=[3, 1 << 40])
    assert port_mcpack.message_to_mcpack(port_req) == jax_mcpack.message_to_mcpack(jax_req)
    jax_mod, jax_ns = build_generated(PKGS["jax"], tmp_path)
    port_mod, port_ns = build_generated(PKGS["torch"], tmp_path)
    for jax_msg, port_msg in zip(generator_samples(jax_mod), generator_samples(port_mod)):
        wire = jax_ns["pack_Outer"](jax_msg)
        assert port_ns["pack_Outer"](port_msg) == wire
        assert port_ns["unpack_Outer"](wire).to_json() == jax_ns["unpack_Outer"](wire).to_json()
