"""The mongo server side (``protocol/mongo.py``) of the port on the CPU, held
against the JAX package's:

- ``tests/test_mongo.py``'s 12 cases on both packages (the BSON subset
  codec and its refusals, OP_QUERY through a ``MongoServiceAdaptor`` with
  its per-connection context, errors serialized as ``$err`` replies,
  fire-and-forget inserts, OP_GET_MORE's "cursor not found", the option
  gate, mongo beside tbus_std on one port);
- the bytes: seeded documents encode to the same BSON in both packages and
  decode alike, seeded OP_REPLY frames and error replies pack alike, and
  each package's head and cut read seeded frames alike at every prefix;
- interop over TCP both ways: the same OP_QUERY frames, built with one
  package's ``bson_encode``, answered byte for byte alike by both packages'
  servers;
- the native plane: a mongo query to a ``native_plane=True`` server is
  handed to the Python plane and answered there, the C++ dispatch counting
  none of it.

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes, integers or strings (the
doubles of the seeded documents round-trip bit for bit)."""

from __future__ import annotations

import socket as pysock
import struct
import threading
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import mongo as jax_mongo
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu_torch.protocol import mongo as port_mongo
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, mongo=jax_mongo,
                                 ParseError=jax_tbus.ParseError, server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, mongo=port_mongo,
                                   ParseError=port_tbus.ParseError,
                                   server_kw={"device": "cpu"}),
}

_OPEN = []  # servers the test started, stopped at teardown


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        srv = _OPEN.pop()
        srv.stop()
        srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def server(pkg, services=None, **opts):
    """A started server of ``pkg`` (stopped at teardown)."""
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts, **pkg.server_kw))
    for name, handlers in (services or {}).items():
        srv.add_service(name, handlers)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


# -- tests/test_mongo.py on both packages --------------------------------------


class TestBson:
    def test_roundtrip_all_kinds(self, pkg):
        mongo = pkg.mongo
        doc = {
            "d": 1.5,
            "s": "text",
            "sub": {"k": 1},
            "arr": [1, "two", None],
            "bin": b"\x00\xff",
            "oid": mongo.ObjectId(b"0123456789ab"),
            "t": True,
            "n": None,
            "i32": 42,
            "i64": 1 << 40,
        }
        data = mongo.bson_encode(doc)
        back, used = mongo.bson_decode(data)
        assert used == len(data)
        assert back == doc

    def test_known_fixture_bytes(self, pkg):
        # {"hello": "world"} per the BSON spec's own worked example:
        # \x16\x00\x00\x00 \x02 hello\x00 \x06\x00\x00\x00 world\x00 \x00
        fixture = b"\x16\x00\x00\x00\x02hello\x00\x06\x00\x00\x00world\x00\x00"
        assert pkg.mongo.bson_encode({"hello": "world"}) == fixture
        doc, used = pkg.mongo.bson_decode(fixture)
        assert doc == {"hello": "world"} and used == len(fixture)

    def test_truncated_rejected(self, pkg):
        data = pkg.mongo.bson_encode({"a": 1, "b": "xx"})
        for cut in (3, 6, len(data) - 1):
            with pytest.raises(pkg.ParseError):
                pkg.mongo.bson_decode(data[:cut] + b"\x00" * 0)

    def test_unknown_element_type_rejected(self, pkg):
        bad = b"\x0b\x00\x00\x00\x7fx\x00\x00\x00\x00\x00"
        with pytest.raises(pkg.ParseError):
            pkg.mongo.bson_decode(bad)

    def test_depth_bomb_rejected(self, pkg):
        doc = {"k": 1}
        for _ in range(200):
            doc = {"d": doc}
        data = pkg.mongo.bson_encode(doc)
        with pytest.raises(pkg.ParseError):
            pkg.mongo.bson_decode(data)

    def test_malformed_raises_parse_error_not_struct_error(self, pkg):
        # a double element whose 8 value bytes overrun the declared length
        bad = struct.pack("<i", 8) + b"\x01d\x00" + b"\x00"
        with pytest.raises(pkg.ParseError):
            pkg.mongo.bson_decode(bad)
        # an "array" whose keys are not numeric indices
        arr_body = pkg.mongo.bson_encode({"notanum": 1})
        elem = b"\x04a\x00" + arr_body
        framed = struct.pack("<i", 4 + len(elem) + 1) + elem + b"\x00"
        with pytest.raises(pkg.ParseError):
            pkg.mongo.bson_decode(framed)


def build_query(mongo, collection: str, query: dict, request_id: int = 7,
                skip: int = 0, limit: int = 0) -> bytes:
    body = (
        struct.pack("<i", 0)
        + collection.encode() + b"\x00"
        + struct.pack("<ii", skip, limit)
        + mongo.bson_encode(query)
    )
    return mongo.HEAD.pack(16 + len(body), request_id, 0, mongo.OP_QUERY) + body


def parse_reply(mongo, data: bytes):
    length, rid, rto, op = mongo.HEAD.unpack_from(data)
    assert op == mongo.OP_REPLY and length == len(data)
    flags, cursor, start, count = struct.unpack_from("<iqii", data, 16)
    docs, off = [], 36
    for _ in range(count):
        doc, used = mongo.bson_decode(data, off)
        docs.append(doc)
        off += used
    return rto, flags, docs


def make_adaptor(mongo):
    class _Adaptor(mongo.MongoServiceAdaptor):
        def __init__(self):
            self.inserts = []

        def create_socket_context(self):
            return {"queries": 0}

        def handle_query(self, ctx, q):
            ctx["queries"] += 1
            if q.collection == "db.fail":
                raise PKGS["jax" if mongo is jax_mongo else "torch"].ParseError("synthetic failure")
            return [{"collection": q.collection, "n": ctx["queries"], **q.query}]

        def handle_insert(self, ctx, body: bytes):
            self.inserts.append(body)

    return _Adaptor()


@pytest.fixture
def mongo_server(pkg):
    adaptor = make_adaptor(pkg.mongo)
    srv = server(pkg, usercode_inline=True, mongo_service_adaptor=adaptor)
    return srv, adaptor


def _recv_reply(conn) -> bytes:
    data = b""
    while len(data) < 4 or len(data) < struct.unpack_from("<i", data)[0]:
        chunk = conn.recv(65536)
        if not chunk:
            break
        data += chunk
    return data


class TestQueryPath:
    def test_query_reply_and_per_conn_context(self, pkg, mongo_server):
        mongo = pkg.mongo
        srv, _ = mongo_server
        conn = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        conn.sendall(build_query(mongo, "db.items", {"x": 1}, request_id=11))
        rto, flags, docs = parse_reply(mongo, _recv_reply(conn))
        assert rto == 11 and flags == 0
        assert docs == [{"collection": "db.items", "n": 1, "x": 1}]
        # same connection: the context counter advances (stateful protocol)
        conn.sendall(build_query(mongo, "db.items", {}, request_id=12))
        _, _, docs2 = parse_reply(mongo, _recv_reply(conn))
        assert docs2[0]["n"] == 2
        conn.close()
        # a NEW connection gets a fresh context
        conn2 = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        conn2.sendall(build_query(mongo, "db.items", {}, request_id=13))
        _, _, docs3 = parse_reply(mongo, _recv_reply(conn2))
        assert docs3[0]["n"] == 1
        conn2.close()

    def test_adaptor_error_serializes_err_reply(self, pkg, mongo_server):
        srv, _ = mongo_server
        conn = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        conn.sendall(build_query(pkg.mongo, "db.fail", {}, request_id=21))
        rto, flags, docs = parse_reply(pkg.mongo, _recv_reply(conn))
        assert rto == 21
        assert flags & 2  # QueryFailure
        assert "$err" in docs[0]
        conn.close()

    def test_insert_is_fire_and_forget(self, pkg, mongo_server):
        mongo = pkg.mongo
        srv, adaptor = mongo_server
        body = struct.pack("<i", 0) + b"db.c\x00" + mongo.bson_encode({"v": 1})
        frame = mongo.HEAD.pack(16 + len(body), 31, 0, mongo.OP_INSERT) + body
        conn = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        conn.sendall(frame)
        # follow with a query to prove the connection survived the no-reply op
        conn.sendall(build_query(mongo, "db.c", {}, request_id=32))
        rto, _, _ = parse_reply(mongo, _recv_reply(conn))
        assert rto == 32
        assert len(adaptor.inserts) == 1
        conn.close()

    def test_get_more_reports_cursor_not_found(self, pkg, mongo_server):
        mongo = pkg.mongo
        srv, _ = mongo_server
        body = struct.pack("<i", 0) + b"db.c\x00" + struct.pack("<iq", 0, 99)
        frame = mongo.HEAD.pack(16 + len(body), 41, 0, mongo.OP_GET_MORE) + body
        conn = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        conn.sendall(frame)
        rto, flags, docs = parse_reply(mongo, _recv_reply(conn))
        assert rto == 41 and flags & 1 and docs == []
        conn.close()


class TestGating:
    def test_disabled_without_adaptor(self, pkg):
        """A server with no adaptor must not speak mongo (the reference
        returns TRY_OTHERS, and the scan then rejects the bytes)."""
        srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, usercode_inline=True)
        conn = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        conn.sendall(build_query(pkg.mongo, "db.x", {}))
        conn.settimeout(3)
        assert conn.recv(1024) == b""  # connection failed, no reply
        conn.close()

    def test_multiplexed_with_tbus_on_one_port(self, pkg, mongo_server):
        srv, _ = mongo_server
        srv._methods  # server also serves tbus_std on the same port
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}")
        c = ch.call_method("nosuch", "m", b"")
        # tbus_std reached the server's request path (error ≠ transport kill)
        assert c.failed() and c.error_code in (1001, 1002)


# -- the bytes -------------------------------------------------------------------


def seeded_doc(rng, depth=0):
    doc = {}
    for i in range(int(rng.integers(0, 7))):
        key = rng.integers(97, 123, int(rng.integers(1, 8)), dtype=np.uint8).tobytes().decode()
        kind = int(rng.integers(0, 11 if depth < 3 else 9))
        if kind == 0:
            v = float(rng.standard_normal() * 10 ** rng.uniform(-30, 30))
        elif kind == 1:
            v = "".join(chr(int(c)) for c in rng.integers(32, 0x3000, int(rng.integers(0, 12))))
        elif kind == 2:
            v = rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8).tobytes()
        elif kind == 3:
            v = jax_mongo.ObjectId(rng.integers(0, 256, 12, dtype=np.uint8).tobytes())
        elif kind == 4:
            v = bool(rng.integers(0, 2))
        elif kind == 5:
            v = None
        elif kind == 6:
            v = int(rng.integers(-(1 << 31), 1 << 31))
        elif kind in (7, 8):
            v = int(rng.integers(-(1 << 62), 1 << 62))
        elif kind == 9:
            v = seeded_doc(rng, depth + 1)
        else:
            v = list(seeded_doc(rng, depth + 1).values())
        doc[f"{key}{i}"] = v
    return doc


def _port_doc(v):
    """The seeded document with the port's ObjectId in place of the JAX
    package's (the encoders test for their own class)."""
    if isinstance(v, jax_mongo.ObjectId):
        return port_mongo.ObjectId(bytes(v))
    if isinstance(v, dict):
        return {k: _port_doc(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_port_doc(x) for x in v]
    return v


def test_bson_identical_across_packages():
    rng = np.random.default_rng(28)
    for _ in range(80):
        doc = seeded_doc(rng)
        data = jax_mongo.bson_encode(doc)
        assert port_mongo.bson_encode(_port_doc(doc)) == data
        jdoc, jn = jax_mongo.bson_decode(data)
        pdoc, pn = port_mongo.bson_decode(data)
        assert pn == jn == len(data) and pdoc == jdoc == doc
        for cut in sorted({c for c in (4, 5, len(data) // 2, len(data) - 1) if c < len(data)}):
            for m, err in ((jax_mongo, jax_tbus.ParseError), (port_mongo, port_tbus.ParseError)):
                with pytest.raises(err):
                    m.bson_decode(data[:cut])


def test_frames_identical_across_packages():
    rng = np.random.default_rng(29)
    adaptors = (jax_mongo.MongoServiceAdaptor(), port_mongo.MongoServiceAdaptor())
    for _ in range(30):
        docs = [seeded_doc(rng) for _ in range(int(rng.integers(0, 4)))]
        kw = dict(request_id=int(rng.integers(-(1 << 31), 1 << 31)),
                  response_flags=int(rng.integers(0, 16)),
                  cursor_id=int(rng.integers(-(1 << 62), 1 << 62)),
                  starting_from=int(rng.integers(0, 1 << 20)))
        rto = int(rng.integers(-(1 << 31), 1 << 31))
        wire = jax_mongo.pack_reply(rto, docs, **kw)
        assert port_mongo.pack_reply(rto, [_port_doc(d) for d in docs], **kw) == wire
        message = "".join(chr(int(c)) for c in rng.integers(32, 127, 20))
        assert adaptors[1].serialize_error(rto, message) == adaptors[0].serialize_error(rto, message)
        qdoc = seeded_doc(rng)
        query = build_query(jax_mongo, "db.c", qdoc, request_id=rto)
        assert build_query(port_mongo, "db.c", _port_doc(qdoc), request_id=rto) == query
        for frame in (wire, query):
            for cut in sorted({0, 3, 4, 15, 16, len(frame) - 1, len(frame)}):
                part = frame[:cut]
                assert port_mongo.parse_header(part) == jax_mongo.parse_header(part)
                j, jn = jax_mongo.try_parse_frame(part)
                p, pn = port_mongo.try_parse_frame(part)
                assert pn == jn
                if j is not None:
                    assert (p.request_id, p.response_to, p.op_code, p.body) == \
                        (j.request_id, j.response_to, j.op_code, j.body)
        jq, pq = jax_mongo.QueryMessage(query[16:]), port_mongo.QueryMessage(query[16:])
        assert [getattr(pq, f) for f in pq.__slots__] == [getattr(jq, f) for f in jq.__slots__]
    for bad in (struct.pack("<iiii", 8, 0, 0, 2004), struct.pack("<iiii", 40, 0, 0, 9999)):
        for m, err in ((jax_mongo, jax_tbus.ParseError), (port_mongo, port_tbus.ParseError)):
            with pytest.raises(err):
                m.parse_header(bad)


# -- interop over TCP both ways ------------------------------------------------


@pytest.mark.parametrize("client,srv_pkg", [("torch", "jax"), ("jax", "torch")],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_interop_both_ways(client, srv_pkg):
    """OP_QUERY frames built with one package's codec, sent to the other's
    server, answered with the same bytes as the building package's server
    answers them."""
    cp, sp = PKGS[client], PKGS[srv_pkg]
    theirs = server(sp, usercode_inline=True, mongo_service_adaptor=make_adaptor(sp.mongo))
    own = server(cp, usercode_inline=True, mongo_service_adaptor=make_adaptor(cp.mongo))
    rng = np.random.default_rng(32)
    queries = [build_query(cp.mongo, "db.items", {"data": rng.integers(
        0, 256, 300, dtype=np.uint8).tobytes(), "i": i}, request_id=100 + i) for i in range(6)]
    queries.append(build_query(cp.mongo, "db.fail", {}, request_id=200))
    answers = []
    for srv in (theirs, own):
        with pysock.create_connection(("127.0.0.1", srv.port), timeout=10) as conn:
            got = []
            for q in queries:
                conn.sendall(q)
                got.append(_recv_reply(conn))
            answers.append(got)
    assert answers[0] == answers[1]
    rto, flags, docs = parse_reply(cp.mongo, answers[0][0])
    assert rto == 100 and flags == 0 and docs[0]["n"] == 1 and docs[0]["i"] == 0


# -- the native plane ----------------------------------------------------------------


def test_native_plane_hands_mongo_off(pkg):
    """A mongo connection to a native-plane server is handed to the Python
    plane (its first four bytes, a little-endian length, are neither
    tbus_std's nor baidu_std's magic) and answered there; the C++ dispatch
    counts none of it."""
    srv = server(pkg, {"svc": {"echo": lambda cntl, req: req}}, native_plane=True,
                 mongo_service_adaptor=make_adaptor(pkg.mongo))
    plane = srv._native_plane
    assert plane is not None
    before = plane.stats()
    with pysock.create_connection(("127.0.0.1", srv.port), timeout=10) as conn:
        for i in range(3):
            conn.sendall(build_query(pkg.mongo, "db.items", {"x": i}, request_id=50 + i))
            rto, flags, docs = parse_reply(pkg.mongo, _recv_reply(conn))
            assert (rto, flags, docs) == (50 + i, 0, [{"collection": "db.items", "n": i + 1,
                                                       "x": i}])
    after = plane.stats()
    assert after["native_reqs"] == before["native_reqs"]
    assert after["handoffs"] - before["handoffs"] == 1
