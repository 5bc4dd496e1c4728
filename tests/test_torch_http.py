"""HTTP (``protocol/http.py``, ``builtin/pages.py``, the server's gateway,
restful mappings and HTTP handlers, the http channel) of the port on the
CPU, held against the JAX package's:

- from ``tests/test_http.py``, on both packages: ``TestParse``,
  ``TestChunkedResponsesOnChannels``, ``TestHttpChannelClient``,
  ``TestChunkedRequests``, ``TestProgressiveReader``,
  ``TestRestfulMappings``, ``TestPortal``'s ``/health`` and its cases that
  use only custom handlers, ``head_has_no_body`` (its second request reads
  ``/version``) and ``pipelined_responses_in_request_order`` (its slow first
  request is ``/status``);
- ``tests/test_native_plane.py::TestInterop::test_http_handoff_same_port``
  on both (a native-plane server hands an HTTP connection to a Python
  socket and answers ``/health``);
- HTTP on a server with a token table, on the port alone and on both
  of its planes: the gateway, restful mappings and custom handlers answer
  401 without the ``Authorization`` header that verifies, once per
  connection, and the http channel carries its credential (the JAX
  package's gateway never asks the authenticator);
- ``/quitquitquit`` on both: refused (403) while its flag is off, and a
  lame duck that fails ``/health`` with 503 when it is on;
- every builtin page of the JAX package's table (and the ``/vars/``,
  ``/flags/``, ``/dir/`` and ``/protobufs/`` prefixes) answers on the port
  with the JAX package's status and content type, one case a path (never a
  501 or a 404);
- bytes: one script of raw requests (custom handlers, the gateway, restful
  mappings, 404, HEAD, chunked request and response bodies, pipelining)
  draws byte-identical responses from both packages' servers (neither
  writes a date header, so nothing is masked); the channel's request
  packer and the response builders give identical bytes;
- interop both ways: a port http Channel against a JAX-package Server and
  the reverse.

Tolerance: none; every comparison is of bytes, integers or strings."""

import hashlib
import socket as pysocket
import threading
import time

import pytest

import incubator_brpc_tpu as jax_root
import incubator_brpc_tpu_torch as port_root
from incubator_brpc_tpu.builtin import pages as jax_pages
from incubator_brpc_tpu.protocol import http as jax_http
from incubator_brpc_tpu_torch.builtin import pages as port_pages
from incubator_brpc_tpu_torch.protocol import http as port_http
from incubator_brpc_tpu_torch.utils.status import ErrorCode
from tests.test_torch_baidu_std import (  # noqa: F401  (fixtures)
    _OPEN,
    PKGS,
    connect,
    no_port_thread_outlives_the_test,
    pkg,
    server,
)

for _p, _h, _pg in ((PKGS["jax"], jax_http, jax_pages), (PKGS["torch"], port_http, port_pages)):
    _p.http, _p.pages = _h, _pg


def fetch(pkg, srv, path, method="GET", body=b""):
    return pkg.http.http_call("127.0.0.1", srv.port, path, method=method, body=body)


def raw_exchange(port, data, timeout=10):
    """Send ``data`` on a fresh connection; read until the server closes."""
    with pysocket.create_connection(("127.0.0.1", port), timeout=timeout) as conn:
        conn.sendall(data)
        got = b""
        while True:
            try:
                more = conn.recv(65536)
            except OSError:
                break
            if not more:
                break
            got += more
    return got


def _len_handler(frame):
    body = frame.body
    return 200, "text/plain", f"{len(body)}:{hashlib.sha1(body).hexdigest()}".encode()


@pytest.fixture
def portal_server(pkg):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    srv.add_service("demo", {"echo": lambda cntl, req: req})
    srv.add_http_handler("/custom", lambda frame: (200, "text/plain", b"custom-page"))
    srv.add_http_handler("/demo/len", _len_handler)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def handler_server(pkg, handlers, progressive=()):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    for path, fn in handlers.items():
        srv.add_http_handler(path, fn, progressive=path in progressive)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


class TestParse:
    def test_simple_get(self, pkg):
        frame, consumed = pkg.http.parse(b"GET /vars?prefix=socket HTTP/1.1\r\nHost: x\r\n\r\n")
        assert consumed > 0
        assert (frame.method, frame.path, frame.query) == ("GET", "/vars", {"prefix": "socket"})
        assert frame.headers["host"] == "x"
        assert frame.body == b""

    def test_post_with_body(self, pkg):
        raw = b"POST /x HTTP/1.1\r\nContent-Length: 5\r\n\r\nhello"
        frame, consumed = pkg.http.parse(raw)
        assert consumed == len(raw)
        assert frame.body == b"hello"

    def test_incomplete_returns_none(self, pkg):
        assert pkg.http.parse(b"GET /x HTTP/1.1\r\nHost") == (None, 0)
        assert pkg.http.parse(b"POST /x HTTP/1.1\r\nContent-Length: 50\r\n\r\nshort") == (None, 0)

    def test_not_http_raises(self, pkg):
        with pytest.raises(pkg.tbus.ParseError):
            pkg.http.parse(b"TPRC\x00\x00\x00\x00garbage")

    def test_bad_content_length_is_parse_error(self, pkg):
        with pytest.raises(pkg.tbus.ParseError):
            pkg.http.parse(b"POST /x HTTP/1.1\r\nContent-Length: abc\r\n\r\n")
        with pytest.raises(pkg.tbus.ParseError):
            pkg.http.parse(b"POST /x HTTP/1.1\r\nContent-Length: -5\r\n\r\n")
        with pytest.raises(pkg.tbus.ParseError):
            pkg.http.parse_header(b"POST /x HTTP/1.1\r\nContent-Length: abc\r\n\r\n")

    def test_parse_header_sizes_the_frame(self, pkg):
        raw = b"POST /x HTTP/1.1\r\nContent-Length: 5\r\n\r\nhello"
        assert pkg.http.parse_header(raw) == len(raw)
        assert pkg.http.parse_header(b"GET /x HTTP/1.1\r\nHost") is None
        with pytest.raises(pkg.tbus.ParseError):
            pkg.http.parse_header(b"TPRC\x00\x00\x00\x00")

    def test_two_pipelined_requests_cut_one_at_a_time(self, pkg):
        raw = b"GET /a HTTP/1.1\r\n\r\nGET /b HTTP/1.1\r\n\r\n"
        frame, consumed = pkg.http.parse(raw)
        assert frame.path == "/a"
        frame2, consumed2 = pkg.http.parse(raw[consumed:])
        assert frame2.path == "/b"
        assert consumed + consumed2 == len(raw)


class TestPortal:
    def test_health(self, pkg, portal_server):
        status, _, body = fetch(pkg, portal_server, "/health")
        assert status == 200 and body == b"OK"

    def test_custom_handler_and_404(self, pkg, portal_server):
        status, _, body = fetch(pkg, portal_server, "/custom")
        assert status == 200 and body == b"custom-page"
        status, _, _ = fetch(pkg, portal_server, "/definitely-missing")
        assert status == 404

    def test_progressive_chunked_response(self, pkg):
        gate = threading.Event()

        def body():
            yield b"first-chunk"
            gate.wait(timeout=5)
            yield b"second-chunk"

        srv = handler_server(pkg, {"/streamed": lambda frame: (200, "text/plain", body())})
        with pysocket.create_connection(("127.0.0.1", srv.port)) as conn:
            conn.sendall(b"GET /streamed HTTP/1.1\r\n\r\n")
            conn.settimeout(5)
            got = b""
            while b"first-chunk" not in got:
                got += conn.recv(65536)
            assert b"second-chunk" not in got
            assert b"Transfer-Encoding: chunked" in got
            gate.set()
            while b"0\r\n\r\n" not in got:
                got += conn.recv(65536)
            assert b"second-chunk" in got

    def test_pipelined_request_waits_for_stream(self, pkg):
        gate = threading.Event()

        def body():
            yield b"AAA"
            gate.wait(timeout=5)
            yield b"BBB"

        srv = handler_server(pkg, {"/s": lambda frame: (200, "text/plain", body())})
        with pysocket.create_connection(("127.0.0.1", srv.port)) as conn:
            conn.sendall(b"GET /s HTTP/1.1\r\n\r\nGET /health HTTP/1.1\r\nConnection: close\r\n\r\n")
            conn.settimeout(5)
            got = b""
            while b"AAA" not in got:
                got += conn.recv(65536)
            assert b"OK" not in got.split(b"AAA")[-1]
            gate.set()
            while b"HTTP/1.1 200 OK\r\nContent-Length: 2" not in got:
                data = conn.recv(65536)
                if not data:
                    break
                got += data
            term = got.find(b"0\r\n\r\n")
            second = got.find(b"Content-Length: 2")
            assert 0 < term < second

    def test_str_body_is_coerced(self, pkg):
        srv = handler_server(pkg, {"/str": lambda frame: (200, "text/plain", "plain-str")})
        assert fetch(pkg, srv, "/str")[::2] == (200, b"plain-str")

    def test_http_call_decodes_chunked(self, pkg):
        srv = handler_server(pkg, {"/gen": lambda frame: (200, "text/plain",
                                                           (b"x%d|" % i for i in range(5)))})
        status, _, body = fetch(pkg, srv, "/gen")
        assert (status, body) == (200, b"x0|x1|x2|x3|x4|")

    def test_head_has_no_body(self, pkg, portal_server):
        raw = raw_exchange(portal_server.port, b"HEAD /health HTTP/1.1\r\n\r\n"
                           b"GET /version HTTP/1.1\r\nConnection: close\r\n\r\n")
        first_end = raw.find(b"\r\n\r\n") + 4
        assert b"Content-Length: 2" in raw[:first_end]
        second = raw[first_end:]
        version = (jax_root if pkg.name == "jax" else port_root).__version__
        assert second.startswith(b"HTTP/1.1 200") and second.endswith(version.encode())

    def test_pipelined_responses_in_request_order(self, pkg, portal_server):
        # /status is slower than /health; order must still hold
        raw = raw_exchange(portal_server.port, b"GET /status HTTP/1.1\r\n\r\n"
                           b"GET /health HTTP/1.1\r\nConnection: close\r\n\r\n")
        assert raw.count(b"HTTP/1.1 200") == 2
        first_body_at = raw.find(b"\r\n\r\n") + 4
        assert b"server " in raw[first_body_at:first_body_at + 40]  # /status first

    def test_binary_and_http_share_the_port(self, pkg, portal_server):
        ch = connect(pkg, portal_server.port)
        assert ch.call_method("demo", "echo", b"bin").response_payload == b"bin"
        status, _, body = fetch(pkg, portal_server, "/health")
        assert status == 200 and body == b"OK"


class TestChunkedResponsesOnChannels:
    def test_channel_receives_progressive_response(self, pkg):
        def streamy(cntl, req):
            def gen():
                for i in range(64):
                    yield b"chunk-%03d|" % i

            return gen()

        srv = server(pkg, {"s": {"stream": streamy, "plain": lambda c, r: r}})
        ch = connect(pkg, srv.port, protocol="http")
        cntl = ch.call_method("s", "stream", b"", cntl=pkg.rpc.Controller(timeout_ms=30000))
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"".join(b"chunk-%03d|" % i for i in range(64))
        cntl2 = ch.call_method("s", "plain", b"pp", cntl=pkg.rpc.Controller(timeout_ms=30000))
        assert cntl2.ok(), cntl2.error_text
        assert cntl2.response_payload == b"pp"


class TestHttpChannelClient:
    def test_echo_over_http_channel(self, pkg, portal_server):
        cntl = connect(pkg, portal_server.port, protocol="http").call_method(
            "demo", "echo", b"over http")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"over http"
        assert cntl.http_status == 200

    def test_http_error_status_maps_to_ehttp(self, pkg, portal_server):
        cntl = connect(pkg, portal_server.port, protocol="http").call_method(
            "demo", "missing_method", b"")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.EHTTP
        assert "404" in cntl.error_text

    def test_concurrent_pipelined_http_calls(self, pkg, portal_server):
        ch = connect(pkg, portal_server.port, protocol="http", timeout_ms=10000)
        errs = []

        def worker(i):
            for j in range(15):
                body = f"{i}:{j}".encode()
                c = ch.call_method("demo", "echo", body)
                if c.failed() or c.response_payload != body:
                    errs.append((i, j, c.error_code, c.error_text))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs, errs[:3]

    def test_http_channel_and_binary_share_the_server(self, pkg, portal_server):
        hch = connect(pkg, portal_server.port, protocol="http")
        bch = connect(pkg, portal_server.port)
        for i in range(5):
            hc = hch.call_method("demo", "echo", f"h{i}".encode())
            bc = bch.call_method("demo", "echo", f"b{i}".encode())
            assert hc.ok() and hc.response_payload == f"h{i}".encode()
            assert bc.ok() and bc.response_payload == f"b{i}".encode()


def _post_chunked(port, path, chunks, trailers=b""):
    body = b"".join(b"%x\r\n%s\r\n" % (len(c), c) for c in chunks) + b"0\r\n" + trailers + b"\r\n"
    req = (f"POST {path} HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n"
           "Connection: close\r\n\r\n").encode() + body
    return raw_exchange(port, req)


class TestChunkedRequests:
    def test_chunked_post_reassembles(self, pkg, portal_server):
        resp = _post_chunked(portal_server.port, "/demo/echo", [b"hello ", b"chunked ", b"world"])
        assert resp.startswith(b"HTTP/1.1 200")
        assert b"hello chunked world" in resp

    def test_chunked_with_trailers(self, pkg, portal_server):
        resp = _post_chunked(portal_server.port, "/demo/echo", [b"tail"],
                             trailers=b"X-Checksum: abc\r\n")
        assert resp.startswith(b"HTTP/1.1 200")
        assert b"tail" in resp

    def test_malformed_chunk_size_kills_connection(self, pkg, portal_server):
        resp = raw_exchange(portal_server.port, b"POST /demo/echo HTTP/1.1\r\nHost: t\r\n"
                            b"Transfer-Encoding: chunked\r\n\r\nZZZ\r\nnope\r\n0\r\n\r\n")
        assert resp == b""

    def test_chunked_header_signals_stateful_takeover(self, pkg):
        wire = (b"POST /a/b HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: Chunked\r\n\r\n"
                b"3\r\nabc\r\n0\r\n\r\n")
        assert pkg.http.parse_header(wire) is None
        frame, consumed = pkg.http.parse(wire)
        assert consumed == len(wire)
        assert frame.body == b"abc"

    def test_mixed_case_and_multi_codings(self, pkg):
        bad = (b"POST /a/b HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: gzip, chunked\r\n\r\n"
               b"3\r\nabc\r\n0\r\n\r\n")
        with pytest.raises(pkg.tbus.FatalParseError):
            pkg.http.parse_header(bad)
        with pytest.raises(pkg.tbus.FatalParseError):
            pkg.http.parse(bad)

    def test_10mb_chunked_upload(self, pkg, portal_server):
        blob = bytes(range(256)) * 4096 * 10
        chunks = [blob[i:i + 57_000] for i in range(0, len(blob), 57_000)]
        resp = _post_chunked(portal_server.port, "/demo/len", chunks)
        assert resp.startswith(b"HTTP/1.1 200")
        assert f"{len(blob)}:{hashlib.sha1(blob).hexdigest()}".encode() in resp

    def test_chunked_body_over_max_body_size_kills_conn(self, pkg, portal_server):
        old = pkg.flags.get_flag("max_body_size")
        pkg.flags.set_flag_unchecked("max_body_size", 100_000)
        try:
            conn = pysocket.create_connection(("127.0.0.1", portal_server.port), timeout=10)
            chunk = b"x" * 60_000
            conn.sendall(b"POST /demo/len HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n\r\n"
                         + b"%x\r\n%s\r\n" % (len(chunk), chunk))
            try:
                conn.sendall(b"%x\r\n%s\r\n" % (len(chunk), chunk))
            except OSError:
                pass  # the server already failed the connection
            resp = b""
            while True:
                try:
                    data = conn.recv(65536)
                except OSError:
                    break
                if not data:
                    break
                resp += data
            conn.close()
            assert resp == b""
        finally:
            pkg.flags.set_flag_unchecked("max_body_size", old)


class TestProgressiveReader:
    def test_handler_streams_while_uploading(self, pkg):
        seen_progressive = []

        def upload(frame):
            body = frame.body
            if isinstance(body, pkg.http.ProgressiveReader):
                seen_progressive.append(True)
                h = hashlib.sha1()
                n = 0
                while True:
                    piece = body.read(timeout=20)
                    if not piece:
                        break
                    h.update(piece)
                    n += len(piece)
                return 200, "text/plain", f"{n}:{h.hexdigest()}".encode()
            return 200, "text/plain", b"buffered"

        srv = handler_server(pkg, {"/up": upload}, progressive=("/up",))
        blob = b"progressive!" * 100_000
        conn = pysocket.create_connection(("127.0.0.1", srv.port), timeout=10)
        conn.sendall(b"POST /up HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n"
                     b"Connection: close\r\n\r\n")
        for i in range(0, len(blob), 200_000):
            c = blob[i:i + 200_000]
            conn.sendall(b"%x\r\n%s\r\n" % (len(c), c))
        conn.sendall(b"0\r\n\r\n")
        resp = b""
        while True:
            data = conn.recv(65536)
            if not data:
                break
            resp += data
        conn.close()
        assert seen_progressive
        assert resp.startswith(b"HTTP/1.1 200")
        assert f"{len(blob)}:{hashlib.sha1(blob).hexdigest()}".encode() in resp

    def test_client_disconnect_mid_upload_unblocks_handler(self, pkg):
        outcome = []
        seen = threading.Event()

        def upload(frame):
            try:
                while True:
                    piece = frame.body.read(timeout=15)
                    seen.set()
                    if not piece:
                        outcome.append("eof")
                        break
            except IOError as e:
                outcome.append(f"ioerror:{e}")
            return 200, "text/plain", b"x"

        srv = handler_server(pkg, {"/up": upload}, progressive=("/up",))
        conn = pysocket.create_connection(("127.0.0.1", srv.port), timeout=10)
        conn.sendall(b"POST /up HTTP/1.1\r\nHost: t\r\nTransfer-Encoding: chunked\r\n\r\n"
                     b"5\r\nhello\r\n")
        assert seen.wait(10)
        conn.close()
        deadline = time.monotonic() + 10
        while not outcome and time.monotonic() < deadline:
            time.sleep(0.02)
        assert outcome and outcome[0].startswith("ioerror:"), outcome

    def test_pipelined_request_waits_for_progressive_response(self, pkg):
        def upload(frame):
            body = frame.body.read_all(timeout=20)
            time.sleep(0.2)
            return 200, "text/plain", b"U:%d" % len(body)

        srv = handler_server(pkg, {"/up": upload, "/ping": lambda f: (200, "text/plain", b"PONG")},
                             progressive=("/up",))
        resp = raw_exchange(srv.port, b"POST /up HTTP/1.1\r\nHost: t\r\n"
                            b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n"
                            b"GET /ping HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
        u, p = resp.find(b"U:5"), resp.find(b"PONG")
        assert 0 <= u < p, resp[:200]


class TestRestfulMappings:
    @pytest.fixture
    def restful_server(self, pkg):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        srv.add_service("media", {"play": lambda cntl, req: b"play:" + req,
                                  "stat": lambda cntl, req: b"stat"},
                        restful_mappings="/v1/play => play, *.flv => play, /exact/stat => stat")
        assert srv.start(0)
        _OPEN.append(srv)
        return srv

    def test_exact_path(self, pkg, restful_server):
        assert fetch(pkg, restful_server, "/v1/play", "POST", b"X")[::2] == (200, b"play:X")

    def test_wildcard_suffix(self, pkg, restful_server):
        assert fetch(pkg, restful_server, "/live/stream123.flv", "POST", b"F")[::2] == (200, b"play:F")

    def test_no_match_404(self, pkg, restful_server):
        assert fetch(pkg, restful_server, "/v2/play", "POST")[0] == 404

    def test_gateway_route_still_works(self, pkg, restful_server):
        assert fetch(pkg, restful_server, "/media/stat", "POST", b"")[::2] == (200, b"stat")

    def test_bad_mappings_rejected(self, pkg):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        for name, mapping in (("x", "/a -> m"), ("y", "/a => nope"), ("z", "/a/*/b/* => m")):
            with pytest.raises(ValueError):
                srv.add_service(name, {"m": lambda c, r: b""}, restful_mappings=mapping)

    def test_failed_registration_leaves_nothing_behind(self, pkg):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        with pytest.raises(ValueError):
            srv.add_service("p", {"play": lambda c, r: b""},
                            restful_mappings="/ok => play, /bad => nope")
        assert not srv._restful
        assert "p.play" not in srv._methods
        srv.add_service("p", {"play": lambda c, r: b""}, restful_mappings="/ok => play")
        assert len(srv._restful) == 1

    def test_duplicate_paths_rejected(self, pkg):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        srv.add_service("a", {"m": lambda c, r: b""}, restful_mappings="/v1 => m")
        with pytest.raises(ValueError):
            srv.add_service("b", {"n": lambda c, r: b""}, restful_mappings="/v1 => n")


def test_http_handoff_same_port(pkg):
    """tests/test_native_plane.py::TestInterop::test_http_handoff_same_port:
    the native plane hands an HTTP connection to a Python socket."""
    import urllib.request

    srv = server(pkg, {"svc": {"echo": pkg.rpc.native_echo}}, native_plane=True)
    assert srv._native_plane is not None
    body = urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health", timeout=5).read()
    assert body == b"OK\n" or body.startswith(b"OK")
    assert srv._native_plane.stats()["handoffs"] >= 1


def _keepalive_posts(port, requests):
    """POST each ``(path, body, authorization)`` on one keep-alive
    connection; returns [(status, body)]."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        out = []
        for path, body, cred in requests:
            headers = {"Content-Type": "application/octet-stream"}
            if cred is not None:
                headers["Authorization"] = cred
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
        return out
    finally:
        conn.close()


@pytest.mark.parametrize("native_plane", [False, True], ids=["python", "native"])
def test_http_on_an_authenticated_server(native_plane):
    """The port only (the JAX package's gateway never asks the
    authenticator): a server with a token table answers the gateway,
    restful mappings and custom handlers over HTTP only to a connection
    whose ``Authorization`` header verified, once per connection, as its
    binary routes answer only a verified connection; builtin pages pass.
    On the native plane the HTTP connection is handed to the Python
    gateway and held the same."""
    pkg = PKGS["torch"]
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(
        auth=pkg.rpc.TokenAuthenticator(["good-token"]), native_plane=native_plane,
        **pkg.server_kw))
    srv.add_service("demo", {"echo": lambda c, r: r}, restful_mappings="/v1/echo => echo")
    srv.add_http_handler("/hello", lambda frame: (200, "text/plain", b"hi"))
    assert srv.start(0)
    _OPEN.append(srv)
    assert (srv._native_plane is not None) == native_plane
    for path in ("/demo/echo", "/v1/echo", "/hello"):
        for cred in (None, "", "bad-token"):
            assert _keepalive_posts(srv.port, [(path, b"x", cred)]) == [
                (401, b"authentication failed\n")], (path, cred)
    assert _keepalive_posts(srv.port, [("/health", b"", None)])[0][0] == 200
    # verified once: later requests on the connection need no header
    assert _keepalive_posts(srv.port, [
        ("/demo/echo", b"abc", "good-token"), ("/v1/echo", b"def", None),
        ("/hello", b"", None),
    ]) == [(200, b"abc"), (200, b"def"), (200, b"hi")]
    # the http channel carries the channel's credential
    ok = connect(pkg, srv.port, protocol="http", max_retry=0,
                 auth=pkg.rpc.TokenAuthenticator(["good-token"]))
    for body in (b"one", b"two"):
        c = ok.call_method("demo", "echo", body)
        assert c.ok() and c.response_payload == body, c.error_text
    for auth in (None, pkg.rpc.TokenAuthenticator(["bad-token"])):
        bad = connect(pkg, srv.port, protocol="http", max_retry=0, auth=auth)
        c = bad.call_method("demo", "echo", b"x")
        assert (c.error_code, c.http_status) == (ErrorCode.EHTTP, 401)
        # the binary route refuses the same caller
        bad = connect(pkg, srv.port, protocol="baidu_std", max_retry=0, auth=auth)
        assert bad.call_method("demo", "echo", b"x").error_code == ErrorCode.ERPCAUTH
    if native_plane:
        assert srv._native_plane.stats()["handoffs"] >= 1


def test_quitquitquit_drives_the_lame_duck(pkg):
    srv = server(pkg, {"demo": {"echo": lambda c, r: r}})
    assert fetch(pkg, srv, "/quitquitquit")[0] == 403
    old = pkg.flags.get_flag("enable_quitquitquit")
    pkg.flags.set_flag_unchecked("enable_quitquitquit", True)
    try:
        assert fetch(pkg, srv, "/quitquitquit?grace_s=-1")[0] == 400
        assert fetch(pkg, srv, "/quitquitquit?grace_s=x")[0] == 400
        status, _, body = fetch(pkg, srv, "/quitquitquit?grace_s=5")
        assert (status, body) == (200, b"lame-duck drain started\n")
        assert srv.lame_duck
        srv._lame_duck_thread.join(timeout=30)
        assert not srv._lame_duck_thread.is_alive() and not srv.running
    finally:
        pkg.flags.set_flag_unchecked("enable_quitquitquit", old)


def test_health_fails_in_lame_duck(pkg):
    srv = server(pkg, {"demo": {"echo": lambda c, r: r}})
    ch = connect(pkg, srv.port, protocol="http", max_retry=0)
    c = ch.call_method("x", "y", b"", cntl=pkg.rpc.Controller())
    assert c.error_code == ErrorCode.EHTTP  # the connection is open
    cntl = pkg.rpc.Controller()
    cntl.request_extra["http_method"] = "GET"
    cntl.request_extra["http_path"] = "/health"
    assert ch.call_method("", "", b"", cntl=cntl).response_payload == b"OK"
    srv.enter_lame_duck(5.0)
    cntl = pkg.rpc.Controller()
    cntl.request_extra.update(http_method="GET", http_path="/health")
    c = ch.call_method("", "", b"", cntl=cntl)
    assert (c.error_code, c.http_status) == (ErrorCode.EHTTP, 503)
    assert "lame-duck" in c.error_text
    srv._lame_duck_thread.join(timeout=30)
    assert not srv._lame_duck_thread.is_alive()


# every page of the JAX package's table but the two served since A11a, and
# the prefixed forms; /hotspots samples for 0.05 s
WAITING = sorted(set(jax_pages._PAGES) - {"/health", "/quitquitquit"}) + [
    "/vars/socket_in_bytes", "/flags/max_body_size", "/dir/tmp", "/protobufs/demo"]
QUERY = {"/hotspots": "?seconds=0.05", "/pprof/profile": "?seconds=0.05"}


def test_unported_pages_are_the_jax_packages():
    # the port's routing table is the JAX package's, page for page
    assert set(port_pages._PAGES) == set(jax_pages._PAGES)


@pytest.mark.parametrize("path", WAITING)
def test_builtin_page_waiting_for_a12_answers_501(path):
    """The page answers on the port as on the JAX package: the same status
    and content type, never a 501."""
    answers = []
    for pkg in (PKGS["jax"], PKGS["torch"]):
        srv = server(pkg, {"demo": {"echo": lambda c, r: r}})
        status, headers, body = fetch(pkg, srv, path + QUERY.get(path, ""))
        answers.append((status, headers.get("content-type")))
    assert answers[1][0] != 501
    assert answers[1] == answers[0]


# -- the bytes of both packages ------------------------------------------------


def _script_server(pkg):
    def streamy(cntl, req):
        return (b"part-%d;" % i for i in range(5))

    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    srv.add_service("demo", {"echo": lambda c, r: r, "stream": streamy,
                             "fail": lambda c, r: c.set_failed(ErrorCode.EREQUEST, "no way")},
                    restful_mappings="/v1/*/echo => echo")
    srv.add_http_handler("/custom", lambda frame: (200, "text/plain", b"custom-page"))
    srv.add_http_handler("/hdr", lambda frame: (503, "text/plain", b"busy", {"Retry-After": "3"}))
    srv.add_http_handler("/q/", lambda frame: (200, "text/plain",
                                                repr(sorted(frame.query.items())).encode()))
    srv.add_http_handler("/len", _len_handler)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


SCRIPT = [
    b"GET /custom HTTP/1.1\r\nConnection: close\r\n\r\n",
    b"GET /nothing HTTP/1.1\r\nConnection: close\r\n\r\n",
    b"GET /hdr HTTP/1.1\r\nConnection: close\r\n\r\n",
    b"GET /q/x?b=2&a=1&c= HTTP/1.1\r\nConnection: close\r\n\r\n",
    b"POST /demo/echo HTTP/1.1\r\nContent-Length: 5\r\nConnection: close\r\n\r\nhello",
    b"POST /demo/fail HTTP/1.1\r\nContent-Length: 0\r\nConnection: close\r\n\r\n",
    b"POST /demo/nope HTTP/1.1\r\nContent-Length: 0\r\nConnection: close\r\n\r\n",
    b"POST /v1/abc/echo HTTP/1.1\r\nContent-Length: 4\r\nConnection: close\r\n\r\nrest",
    b"GET /demo/stream HTTP/1.1\r\nConnection: close\r\n\r\n",
    b"HEAD /custom HTTP/1.1\r\n\r\nGET /health HTTP/1.1\r\nConnection: close\r\n\r\n",
    b"POST /len HTTP/1.1\r\nTransfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
    b"3\r\nabc\r\n4;ext=1\r\ndefg\r\n0\r\nX-T: 1\r\n\r\n",
    b"GET /custom HTTP/1.1\r\n\r\nPOST /demo/echo HTTP/1.1\r\nContent-Length: 2\r\n\r\nhi"
    b"GET /nothing HTTP/1.1\r\nConnection: close\r\n\r\n",
    b"GET /custom HTTP/1.0\r\nConnection: close\r\n\r\n",
    b"BREW /custom HTTP/1.1\r\n\r\n",
    b"GET /custom HTTP/2.0\r\n\r\n",
]


def test_raw_script_draws_identical_responses():
    answers = {name: [raw_exchange(_script_server(p).port, req) for req in SCRIPT]
               for name, p in PKGS.items()}
    for req, a, b in zip(SCRIPT, answers["jax"], answers["torch"]):
        assert a == b, req
    assert answers["torch"][0].startswith(b"HTTP/1.1 200 OK\r\nContent-Length: 11")


def test_builders_and_packer_byte_identical():
    for status in (200, 302, 400, 404, 500, 503, 299):
        for ka in (True, False):
            args = (status, b"body-%d" % status, "text/html", {"X-A": "1"}, ka)
            assert jax_http.build_response(*args) == port_http.build_response(*args)
            assert (jax_http.build_chunked_head(status, "a/b", ka)
                    == port_http.build_chunked_head(status, "a/b", ka))
    for data in (b"", b"x", bytes(range(256)) * 3):
        assert jax_http.build_chunk(data) == port_http.build_chunk(data)
    for i, extra in enumerate(({}, {"http_host": "h:1"}, {"http_method": "get", "http_path": "/p"})):
        metas = [p.tbus.Meta(service="svc", method="m%d" % i, log_id=i, extra=dict(extra))
                 for p in PKGS.values()]
        wires = [p.http.pack_channel_request(m, b"payload%d" % i, i)
                 for p, m in zip(PKGS.values(), metas)]
        assert wires[0] == wires[1]


@pytest.mark.parametrize("direction", ["port-channel-jax-server", "jax-channel-port-server"])
def test_http_interop(direction):
    srv_pkg, ch_pkg = ((PKGS["jax"], PKGS["torch"]) if direction.startswith("port")
                       else (PKGS["torch"], PKGS["jax"]))
    srv = server(srv_pkg, {"demo": {"echo": lambda c, r: r[::-1],
                                    "stream": lambda c, r: (b"%d," % i for i in range(20))}})
    ch = connect(ch_pkg, srv.port, protocol="http")
    for i in range(5):
        c = ch.call_method("demo", "echo", b"abc%d" % i)
        assert c.ok() and c.response_payload == b"%dcba" % i
    c = ch.call_method("demo", "stream", b"")
    assert c.ok() and c.response_payload == b"".join(b"%d," % i for i in range(20))
    c = ch.call_method("demo", "nope", b"")
    assert c.error_code == ErrorCode.EHTTP and "404" in c.error_text


# -- chip_smoke.py's phase 3h on the CPU ----------------------------------------


def test_chip_smoke_phase_3h_on_the_cpu():
    """Phase 3h's parts (a)-(d) at a small scale on the CPU: every device
    echo over baidu_std (both planes, both clients), the HTTP gateway, the
    http channel and the json2pb service checks itself bitwise, and the
    bench rows' floods stay off the interpreter (no card, so no launch is
    counted)."""
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.protocol_phase(torch, kernels, device="cpu", scale=0.05)
    assert set(k1) == set("abcd")
    assert all(row == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}
               for row in k1.values())
    turns = chip_smoke.PROTO_TURNS
    assert len(out["a"]["seq_us"]) == len(out["b"]["native_seq_us"]) == turns
    assert out["b"]["cb_frames"] > 0
    c = out["c"]
    for row in ("prpc_plain_4k_pump_ns", "prpc_compressed_pump_ns",
                "prpc_compressed_incompressible_pump_ns", "prpc_auth_pump_ns"):
        assert len(c[row]) == chip_smoke.PRPC_PUMP[2] and min(c[row]) > 0
    assert len(c["rpc_echo_prpc_snappy_us"]) == len(c["rpc_echo_prpc_snappy_python_us"]) == 3
    assert out["d"]["json2pb_fields"] == ["data", "seq", "tag", "words"]
