"""json2pb (``protocol/json2pb.py``) of the port on the CPU, held against
the JAX package's:

- ``tests/test_json2pb.py``'s 10 cases (the schema codec: binary and JSON
  round trips, proto2 wire bytes, unknown fields, base64 bytes, bad JSON,
  duplicate field numbers; the typed service over the binary channel and
  over the HTTP gateway, JSON transcoded in and out, a JSON error as 400,
  a binary body passed through) on both packages, each with its own
  ``Message`` classes of the same schema;
- one seeded set of messages (every kind: int, bool, str, bytes, float,
  nested, repeated) encodes to identical ``to_binary`` and ``to_json``
  bytes in both packages, and each package decodes the other's bytes to
  equal values;
- the gateway of each package answers the same curl-style JSON POSTs with
  the same status, content type and body.

Tolerance: none; every comparison is of bytes or equal values (the float
field round-trips its IEEE double exactly)."""

import json

import numpy as np
import pytest

from incubator_brpc_tpu.protocol import json2pb as jax_j2p
from incubator_brpc_tpu.protocol import http as jax_http
from incubator_brpc_tpu_torch.protocol import json2pb as port_j2p
from incubator_brpc_tpu_torch.protocol import http as port_http
from tests.test_torch_baidu_std import (  # noqa: F401  (fixtures)
    PKGS,
    connect,
    no_port_thread_outlives_the_test,
    pkg,
    server,
)

for _p, _j, _h in ((PKGS["jax"], jax_j2p, jax_http), (PKGS["torch"], port_j2p, port_http)):
    _p.j2p, _p.http = _j, _h

_SCHEMAS = {}


def schema(pkg):
    """tests/test_json2pb.py's classes, built on ``pkg``'s Message."""
    if pkg.name not in _SCHEMAS:
        Message, field = pkg.j2p.Message, pkg.j2p.field

        class Inner(Message):
            tag = field(1, str)

        class EchoRequest(Message):
            msg = field(1, str)
            count = field(2, int)
            blob = field(3, bytes)
            ratio = field(4, float)
            flags = field(5, int, repeated=True)
            inner = field(6, Inner)

        class EchoResponse(Message):
            msg = field(1, str)
            total = field(2, int)

        class Every(Message):
            i = field(1, int)
            b = field(2, bool)
            s = field(3, str)
            raw = field(4, bytes)
            f = field(5, float)
            inner = field(6, Inner)
            ri = field(7, int, repeated=True)
            rs = field(8, str, repeated=True)
            rinner = field(9, Inner, repeated=True)
            rf = field(10, float, repeated=True)

        _SCHEMAS[pkg.name] = dict(Inner=Inner, EchoRequest=EchoRequest,
                                  EchoResponse=EchoResponse, Every=Every)
    return _SCHEMAS[pkg.name]


class TestSchemaCodec:
    def test_binary_roundtrip(self, pkg):
        S = schema(pkg)
        m = S["EchoRequest"](msg="hi", count=7, blob=b"\x00\x01", ratio=2.5, flags=[1, 2, 3],
                             inner=S["Inner"](tag="t"))
        assert S["EchoRequest"].from_binary(m.to_binary()) == m

    def test_proto2_wire_bytes_exact(self, pkg):
        assert schema(pkg)["EchoRequest"](msg="hi", count=7).to_binary() == b"\x0a\x02hi\x10\x07"

    def test_unknown_fields_skipped(self, pkg):
        S = schema(pkg)
        blob = S["EchoRequest"](msg="x").to_binary()
        tag = (99 << 3) | 0
        blob += bytes([tag & 0x7F | 0x80, tag >> 7]) + b"\x05"
        assert S["EchoRequest"].from_binary(blob).msg == "x"

    def test_json_roundtrip_and_base64_bytes(self, pkg):
        S = schema(pkg)
        m = S["EchoRequest"](msg="J", blob=b"\xff\xfe", inner=S["Inner"](tag="i"))
        j = json.loads(m.to_json())
        assert j["msg"] == "J"
        assert j["inner"] == {"tag": "i"}
        back = S["EchoRequest"].from_json(m.to_json())
        assert back.blob == b"\xff\xfe"
        assert back.inner.tag == "i"

    def test_bad_json_raises(self, pkg):
        req = schema(pkg)["EchoRequest"]
        for bad in (b"not json", b"[1,2]", b'{"count": "not-an-int-at-all"}'):
            with pytest.raises(pkg.tbus.ParseError):
                req.from_json(bad)

    def test_duplicate_field_numbers_rejected(self, pkg):
        with pytest.raises(TypeError):
            class Bad(pkg.j2p.Message):
                a = pkg.j2p.field(1, str)
                b = pkg.j2p.field(1, int)


class TestTypedService:
    @pytest.fixture
    def typed_server(self, pkg):
        S = schema(pkg)

        def echo(cntl, req):
            return S["EchoResponse"](msg=req.msg * max(1, req.count or 1),
                                     total=(req.count or 0) + sum(req.flags))

        return server(pkg, {"TypedEcho": pkg.j2p.make_typed_service(
            {"Echo": (echo, S["EchoRequest"], S["EchoResponse"])})})

    def fetch(self, pkg, srv, path, method="GET", body=b""):
        return pkg.http.http_call("127.0.0.1", srv.port, path, method=method, body=body)

    def test_binary_rpc_call(self, pkg, typed_server):
        S = schema(pkg)
        ch = connect(pkg, typed_server.port)
        req = S["EchoRequest"](msg="ab", count=2, flags=[10])
        cntl = ch.call_method("TypedEcho", "Echo", req.to_binary())
        assert cntl.ok(), cntl.error_text
        resp = S["EchoResponse"].from_binary(cntl.response_payload)
        assert (resp.msg, resp.total) == ("abab", 12)

    def test_curl_style_json_call(self, pkg, typed_server):
        status, headers, body = self.fetch(pkg, typed_server, "/TypedEcho/Echo", "POST",
                                           json.dumps({"msg": "z", "count": 3}).encode())
        assert status == 200
        assert "json" in headers.get("content-type", "")
        obj = json.loads(body)
        assert (obj["msg"], obj["total"]) == ("zzz", 3)

    def test_json_error_is_400(self, pkg, typed_server):
        status, _, body = self.fetch(pkg, typed_server, "/TypedEcho/Echo", "POST",
                                     b'{"count": "garbage-string"}')
        assert status == 400
        assert b"bad request json" in body

    def test_binary_body_still_passes_through_gateway(self, pkg, typed_server):
        S = schema(pkg)
        req = S["EchoRequest"](msg="q", count=2).to_binary()
        status, headers, body = self.fetch(pkg, typed_server, "/TypedEcho/Echo", "POST", req)
        assert status == 200
        assert "octet-stream" in headers.get("content-type", "")
        assert S["EchoResponse"].from_binary(body).msg == "qq"


# -- both packages' codecs on one seeded set ----------------------------------


def _every(pkg, rng_seed, n=50):
    S = schema(pkg)
    rng = np.random.default_rng(rng_seed)
    out = []
    for k in range(n):
        kw = {}
        if k % 2:
            kw["i"] = int(rng.integers(-(1 << 62), 1 << 62))
        if k % 3:
            kw["b"] = bool(k % 2)
        if k % 4:
            kw["s"] = "ünïcode-%d" % int(rng.integers(1 << 30))
        if k % 5:
            kw["raw"] = rng.integers(0, 256, size=int(rng.integers(0, 64)), dtype=np.uint8).tobytes()
        if k % 6:
            kw["f"] = float(rng.standard_normal())
        if k % 7:
            kw["inner"] = S["Inner"](tag="in%d" % k)
        kw["ri"] = [int(x) for x in rng.integers(0, 1 << 40, size=k % 5)]
        kw["rs"] = ["r%d" % j for j in range(k % 3)]
        kw["rinner"] = [S["Inner"](tag="x%d" % j) for j in range(k % 4)]
        kw["rf"] = [float(x) for x in rng.standard_normal(k % 3)]
        out.append(S["Every"](**kw))
    return out


def test_to_binary_and_to_json_identical():
    msgs = {name: _every(p, 17) for name, p in PKGS.items()}
    for mj, mt in zip(msgs["jax"], msgs["torch"]):
        assert mj.to_binary() == mt.to_binary()
        assert mj.to_json() == mt.to_json()
        # each package decodes the other's bytes to equal values
        Ej, Et = schema(PKGS["jax"])["Every"], schema(PKGS["torch"])["Every"]
        assert Et.from_binary(mj.to_binary()).to_binary() == mj.to_binary()
        assert Ej.from_binary(mt.to_binary()).to_binary() == mt.to_binary()
        assert Et.from_json(mj.to_json()).to_json() == mj.to_json()
        assert Ej.from_json(mt.to_json()).to_json() == mt.to_json()


def test_gateways_answer_json_alike():
    bodies = [json.dumps({"msg": "ab", "count": 2, "flags": [1, 2]}).encode(), b"{}", b"",
              b'{"count": "x"}', b"{not json", json.dumps({"msg": "q", "extra": 1}).encode()]
    answers = {}
    for name, p in PKGS.items():
        S = schema(p)

        def echo(cntl, req, S=S):
            return S["EchoResponse"](msg=req.msg * max(1, req.count or 1),
                                     total=(req.count or 0) + sum(req.flags))

        srv = server(p, {"TypedEcho": p.j2p.make_typed_service(
            {"Echo": (echo, S["EchoRequest"], S["EchoResponse"])})})
        answers[name] = [p.http.http_call("127.0.0.1", srv.port, "/TypedEcho/Echo", "POST", b)
                         for b in bodies]
    assert answers["jax"] == answers["torch"]
