"""RESP (``protocol/resp.py``), the binary memcache wire
(``protocol/memcache_binary.py``) and the HTTP gateway of the port on the
CPU, held against the JAX package's:

- ``tests/test_ecosystem.py``'s 19 cases on both packages (the RESP codec,
  the pipelined redis client and its AUTH, the binary memcache header, op
  matrix and SASL, the ``/<service>/<method>`` gateway);
- the bytes: seeded commands pack to the same RESP arrays, seeded requests
  and responses to the same 24-byte-headed memcache packets, and each
  package's reply parser and packet cut read the other's bytes alike, at
  every prefix length;
- interop over TCP both ways: each package's client against the other's
  mock server (redis with AUTH, memcache binary with SASL).

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes, integers or strings."""

from __future__ import annotations

import struct
import threading
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import http as jax_http
from incubator_brpc_tpu.protocol import memcache_binary as jax_mb
from incubator_brpc_tpu.protocol import resp as jax_resp
from incubator_brpc_tpu.utils import status as jax_status
from incubator_brpc_tpu_torch.protocol import http as port_http
from incubator_brpc_tpu_torch.protocol import memcache_binary as port_mb
from incubator_brpc_tpu_torch.protocol import resp as port_resp
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils import status as port_status

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, resp=jax_resp, mb=jax_mb,
                                 http_call=jax_http.http_call, ErrorCode=jax_status.ErrorCode,
                                 server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, resp=port_resp, mb=port_mb,
                                   http_call=port_http.http_call,
                                   ErrorCode=port_status.ErrorCode,
                                   server_kw={"device": "cpu"}),
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


# -- tests/test_ecosystem.py on both packages ----------------------------------


class TestRespCodec:
    def test_pack_command(self, pkg):
        assert (
            pkg.resp.pack_command("SET", "k", "v")
            == b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"
        )
        assert pkg.resp.pack_command("INCRBY", "k", 5) == (
            b"*3\r\n$6\r\nINCRBY\r\n$1\r\nk\r\n$1\r\n5\r\n"
        )

    def test_parse_simple_types(self, pkg):
        assert pkg.resp.parse_reply(b"+OK\r\n") == ("OK", 5)
        assert pkg.resp.parse_reply(b":42\r\n") == (42, 5)
        r, off = pkg.resp.parse_reply(b"$5\r\nhello\r\n")
        assert (r, off) == (b"hello", 11)
        r, off = pkg.resp.parse_reply(b"$-1\r\n")
        assert r is None and off == 5
        err, _ = pkg.resp.parse_reply(b"-ERR nope\r\n")
        assert isinstance(err, pkg.resp.RespError)

    def test_parse_array_and_nested(self, pkg):
        buf = b"*2\r\n$1\r\na\r\n*2\r\n:1\r\n:2\r\n"
        r, off = pkg.resp.parse_reply(buf)
        assert r == [b"a", [1, 2]]
        assert off == len(buf)

    def test_incomplete_returns_sentinel(self, pkg):
        for partial in (b"", b"$5\r\nhel", b"*2\r\n:1\r\n", b"+OK"):
            r, off = pkg.resp.parse_reply(partial)
            assert off == -1


@pytest.fixture
def redis_pair(pkg):
    server = pkg.resp.MockRedisServer()
    assert server.start()
    client = pkg.resp.RedisClient(f"127.0.0.1:{server.port}")
    yield server, client
    client.close()
    server.stop()


class TestRedisClient:
    def test_basic_commands(self, redis_pair):
        _, c = redis_pair
        assert c.ping() == "PONG"
        assert c.set("k", "v1") == "OK"
        assert c.get("k") == b"v1"
        assert c.get("missing") is None
        assert c.incr("n") == 1
        assert c.incr("n") == 2
        assert c.delete("k", "missing") == 1

    def test_pipeline_order(self, redis_pair):
        _, c = redis_pair
        replies = c.pipeline(
            [("SET", "a", "1"), ("INCR", "a"), ("GET", "a"), ("MGET", "a", "nope")]
        )
        assert replies == ["OK", 2, b"2", [b"2", None]]

    def test_error_reply_raises(self, pkg, redis_pair):
        _, c = redis_pair
        with pytest.raises(pkg.resp.RespError):
            c.execute("NOSUCHCMD")

    def test_concurrent_pipelines(self, redis_pair):
        _, c = redis_pair
        errs = []

        def worker(i):
            try:
                for j in range(50):
                    key = f"t{i}"
                    c.execute("SET", key, f"{j}")
                    assert c.get(key) is not None
            except Exception as e:  # pragma: no cover
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs


@pytest.fixture
def dual_server(pkg):
    server = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))

    def upper(cntl, request):
        return request.upper()

    def fail(cntl, request):
        cntl.set_failed(pkg.ErrorCode.EINTERNAL, "nope")
        return b""

    def later(cntl, request):
        cntl.set_async()
        threading.Timer(0.05, lambda: cntl.send_response(b"async:" + request)).start()
        return None

    server.add_service("svc", {"upper": upper, "fail": fail, "later": later})
    assert server.start(0)
    yield server
    server.stop()
    server.join(timeout=5)


class TestHttpGateway:
    def test_same_method_over_both_protocols(self, pkg, dual_server):
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{dual_server.port}")
        assert ch.call_method("svc", "upper", b"abc").response_payload == b"ABC"
        status, _, body = pkg.http_call(
            "127.0.0.1", dual_server.port, "/svc/upper", method="POST", body=b"abc"
        )
        assert status == 200 and body == b"ABC"

    def test_gateway_counts_in_method_stats(self, pkg, dual_server):
        pkg.http_call("127.0.0.1", dual_server.port, "/svc/upper", method="POST", body=b"x")
        st = dual_server.method_status("svc", "upper")
        assert st.latency.count() >= 1

    def test_gateway_errors_map_to_500(self, pkg, dual_server):
        status, _, body = pkg.http_call(
            "127.0.0.1", dual_server.port, "/svc/fail", method="POST", body=b""
        )
        assert status == 500 and b"nope" in body

    def test_gateway_unknown_is_404(self, pkg, dual_server):
        status, _, _ = pkg.http_call(
            "127.0.0.1", dual_server.port, "/svc/zzz", method="POST", body=b""
        )
        assert status == 404

    def test_gateway_async_handler(self, pkg, dual_server):
        status, _, body = pkg.http_call(
            "127.0.0.1", dual_server.port, "/svc/later", method="POST", body=b"hi"
        )
        assert status == 200 and body == b"async:hi"


class TestRedisAuth:
    """RedisAuthenticator semantics (policy/redis_authenticator.cpp): AUTH
    is the first command on the connection; unauthenticated commands are
    refused."""

    def test_auth_then_commands(self, pkg):
        srv = pkg.resp.MockRedisServer(password="s3cret")
        assert srv.start()
        try:
            c = pkg.resp.RedisClient(f"127.0.0.1:{srv.port}", password="s3cret")
            assert c.execute("SET", "k", "v") in (b"OK", "OK")
            assert c.execute("GET", "k") == b"v"
            c.close()
        finally:
            srv.stop()

    def test_wrong_password_fails_loudly(self, pkg):
        srv = pkg.resp.MockRedisServer(password="s3cret")
        assert srv.start()
        try:
            with pytest.raises(pkg.resp.RespError):
                pkg.resp.RedisClient(f"127.0.0.1:{srv.port}", password="wrong")
        finally:
            srv.stop()

    def test_unauthenticated_commands_refused(self, pkg):
        srv = pkg.resp.MockRedisServer(password="s3cret")
        assert srv.start()
        try:
            c = pkg.resp.RedisClient(f"127.0.0.1:{srv.port}")  # no AUTH
            with pytest.raises(pkg.resp.RespError):
                c.execute("GET", "k")
            c.close()
        finally:
            srv.stop()


class TestMemcacheBinary:
    """The binary memcache wire (policy/memcache_binary_protocol.cpp):
    header fixtures, opaque correlation, full op coverage, SASL auth."""

    def test_header_fixture(self, pkg):
        mb = pkg.mb
        wire = mb.pack_request(mb.OP_SET, b"k", b"v", extras=b"\x00" * 8, opaque=7)
        assert wire[0] == 0x80 and wire[1] == mb.OP_SET
        assert wire[2:4] == b"\x00\x01"          # key length
        assert wire[4] == 8                       # extras length
        assert struct.unpack_from(">I", wire, 8)[0] == 8 + 1 + 1  # total body
        assert wire[12:16] == b"\x00\x00\x00\x07"  # opaque
        assert wire[24:32] == b"\x00" * 8          # extras
        assert wire[32:33] == b"k" and wire[33:34] == b"v"

    @pytest.fixture
    def binary_server(self, pkg):
        srv = pkg.mb.MockMemcacheBinaryServer()
        assert srv.start()
        yield srv
        srv.stop()

    def test_full_op_matrix(self, pkg, binary_server):
        c = pkg.mb.MemcacheBinaryClient(f"127.0.0.1:{binary_server.port}")
        assert c.set("k", b"v1", flags=42)
        assert c.get("k") == b"v1"
        assert c.get("missing") is None
        assert not c.add("k", b"nope")        # exists
        assert c.add("k2", b"fresh")
        assert c.replace("k", b"v2")
        assert not c.replace("ghost", b"x")   # missing
        assert c.append("k", b"+tail")
        assert c.prepend("k", b"head+")
        assert c.get("k") == b"head+v2+tail"
        assert c.set("n", b"10")
        assert c.incr("n", 5) == 15
        assert c.decr("n", 3) == 12
        assert c.incr("missing") is None
        assert c.delete("k") and not c.delete("k")
        assert "tbrpc" in c.version()
        got = c.get_multi("k2", "n", "missing")
        assert got == {"k2": b"fresh", "n": b"12"}
        assert c.flush_all()
        assert c.get("k2") is None
        c.close()

    def test_sasl_auth(self, pkg):
        mb = pkg.mb
        srv = mb.MockMemcacheBinaryServer(password="hunter2")
        assert srv.start()
        try:
            c = mb.MemcacheBinaryClient(f"127.0.0.1:{srv.port}", password="hunter2")
            assert c.set("a", b"1") and c.get("a") == b"1"
            c.close()
            with pytest.raises(mb.MemcacheBinaryError):
                mb.MemcacheBinaryClient(f"127.0.0.1:{srv.port}", password="wrong")
            # unauthenticated commands refused
            plain = mb.MemcacheBinaryClient(f"127.0.0.1:{srv.port}")
            with pytest.raises(mb.MemcacheBinaryError):
                plain.get("a")
            plain.close()
        finally:
            srv.stop()


# -- the bytes -------------------------------------------------------------------


def _word(rng):
    kind = int(rng.integers(0, 3))
    if kind == 0:
        return int(rng.integers(-(1 << 40), 1 << 40))
    raw = rng.integers(0, 256, int(rng.choice([0, 1, 13, 300])), dtype=np.uint8).tobytes()
    return raw if kind == 1 else raw.hex()


def test_resp_bytes_identical_across_packages():
    """Seeded commands pack to the same RESP arrays; seeded replies (every
    RESP type, nested arrays, nil bulks and arrays) parse alike in both
    packages at every prefix length, incomplete ones to the -1 sentinel."""
    rng = np.random.default_rng(28)
    for _ in range(60):
        args = [_word(rng) for _ in range(int(rng.integers(1, 6)))]
        assert port_resp.pack_command(*args) == jax_resp.pack_command(*args)

    def reply(depth=0):
        kind = int(rng.integers(0, 6 if depth < 2 else 5))
        if kind == 0:
            return b"+" + rng.integers(65, 91, int(rng.integers(0, 8)), dtype=np.uint8).tobytes() + b"\r\n"
        if kind == 1:
            return b"-ERR " + rng.integers(97, 123, 5, dtype=np.uint8).tobytes() + b"\r\n"
        if kind == 2:
            return b":%d\r\n" % int(rng.integers(-(1 << 40), 1 << 40))
        if kind == 3:
            body = rng.integers(0, 256, int(rng.integers(0, 40)), dtype=np.uint8).tobytes()
            return b"$%d\r\n%s\r\n" % (len(body), body)
        if kind == 4:
            return b"$-1\r\n"
        n = int(rng.integers(-1, 4))
        return b"*%d\r\n" % n + b"".join(reply(depth + 1) for _ in range(max(n, 0)))

    def same(a, b):
        if isinstance(a, list):
            return isinstance(b, list) and len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, Exception):
            return type(b).__name__ == type(a).__name__ and str(a) == str(b)
        return a == b and type(a) is type(b)

    for _ in range(60):
        wire = reply()
        for cut in range(len(wire) + 1):
            j, jn = jax_resp.parse_reply(wire[:cut])
            p, pn = port_resp.parse_reply(wire[:cut])
            assert pn == jn
            assert same(j, p)
        assert jn == len(wire)


def test_memcache_binary_bytes_identical_across_packages():
    """Seeded requests and responses (opcodes, keys, values, extras,
    opaques, CAS, statuses) pack to the same packets in both packages, and
    each package's cut reads them alike at every prefix length."""
    rng = np.random.default_rng(29)
    ops = [jax_mb.OP_GET, jax_mb.OP_SET, jax_mb.OP_ADD, jax_mb.OP_DELETE, jax_mb.OP_INCREMENT,
           jax_mb.OP_GETK, jax_mb.OP_APPEND, jax_mb.OP_SASL_AUTH, jax_mb.OP_VERSION]
    statuses = [jax_mb.STATUS_OK, jax_mb.STATUS_KEY_NOT_FOUND, jax_mb.STATUS_KEY_EXISTS,
                jax_mb.STATUS_ITEM_NOT_STORED, jax_mb.STATUS_AUTH_ERROR]

    def blob(hi):
        return rng.integers(0, 256, int(rng.integers(0, hi)), dtype=np.uint8).tobytes()

    for _ in range(40):
        op = int(rng.choice(ops))
        key, value, extras = blob(30), blob(200), blob(21)
        opaque, cas = int(rng.integers(0, 1 << 34)), int(rng.integers(0, 1 << 63))
        req = jax_mb.pack_request(op, key, value, extras, opaque=opaque, cas=cas)
        assert port_mb.pack_request(op, key, value, extras, opaque=opaque, cas=cas) == req
        opq = struct.pack(">I", opaque & 0xFFFFFFFF)
        status = int(rng.choice(statuses))
        res = jax_mb.pack_response(op, status, key, value, extras, opq, cas)
        assert port_mb.pack_response(op, status, key, value, extras, opq, cas) == res
        for wire in (req, res):
            for cut in sorted({0, 1, 23, 24, 25, len(wire) - 1, len(wire)}):
                assert port_mb.parse_packet(wire[:max(cut, 0)]) == \
                    jax_mb.parse_packet(wire[:max(cut, 0)])
    for pkg_mb in (jax_mb, port_mb):
        with pytest.raises(pkg_mb.MemcacheBinaryError):
            pkg_mb.parse_packet(b"\x42" + b"\x00" * 23)


# -- interop over TCP both ways ------------------------------------------------

INTEROP = [("torch", "jax"), ("jax", "torch")]
INTEROP_IDS = ["port-client-jax-server", "jax-client-port-server"]


@pytest.mark.parametrize("client,srv_pkg", INTEROP, ids=INTEROP_IDS)
def test_redis_interop_both_ways(client, srv_pkg):
    cp, sp = PKGS[client], PKGS[srv_pkg]
    srv = sp.resp.MockRedisServer(password="pw")
    assert srv.start()
    try:
        c = cp.resp.RedisClient(f"127.0.0.1:{srv.port}", password="pw")
        rng = np.random.default_rng(30)
        values = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes() for _ in range(8)]
        replies = c.pipeline([("SET", f"k{i}", v) for i, v in enumerate(values)]
                             + [("MGET", *[f"k{i}" for i in range(8)]), ("INCR", "n"),
                                ("DEL", "k0", "nope"), ("ECHO", "x"), ("PING",)])
        assert replies == ["OK"] * 8 + [values, 1, 1, b"x", "PONG"]
        with pytest.raises(cp.resp.RespError):
            c.execute("NOSUCHCMD")
        c.close()
        with pytest.raises(cp.resp.RespError):
            cp.resp.RedisClient(f"127.0.0.1:{srv.port}", password="wrong")
    finally:
        srv.stop()


@pytest.mark.parametrize("client,srv_pkg", INTEROP, ids=INTEROP_IDS)
def test_memcache_binary_interop_both_ways(client, srv_pkg):
    cp, sp = PKGS[client], PKGS[srv_pkg]
    srv = sp.mb.MockMemcacheBinaryServer(password="pw")
    assert srv.start()
    try:
        c = cp.mb.MemcacheBinaryClient(f"127.0.0.1:{srv.port}", username="u", password="pw")
        rng = np.random.default_rng(31)
        values = {f"k{i}": rng.integers(0, 256, 100, dtype=np.uint8).tobytes() for i in range(6)}
        for k, v in values.items():
            assert c.set(k, v, flags=3)
        assert c.get_multi(*values, "nope") == values
        assert c.set("n", b"7") and c.incr("n", 5) == 12 and c.decr("n", 20) == 0
        assert c.append("k0", b"!") and c.get("k0") == values["k0"] + b"!"
        assert c.delete("k1") and c.get("k1") is None
        assert c.version() == "1.6.0-tbrpc"
        c.close()
        with pytest.raises(cp.mb.MemcacheBinaryError):
            cp.mb.MemcacheBinaryClient(f"127.0.0.1:{srv.port}", password="wrong")
    finally:
        srv.stop()
