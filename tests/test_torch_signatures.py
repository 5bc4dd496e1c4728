"""Public and internal signatures of the port's host plane against the JAX
package's, parametrised over both packages (ROADMAP C7).

The port keeps the reference's parameters in the reference's places in
``ServerOptions``, ``ChannelOptions``, ``Controller``, ``Channel.init`` and
the link classes ``DeviceLink``/``DeviceSocket``, adding only a keyword-only
``device`` after them where it needs one. The internal ``Acceptor``,
``Socket`` and ``Protocol`` drop reference parameters, so every parameter
after the first of them that may be passed by position is keyword-only. The
tests pin each signature's names and order with ``inspect``, and run each
positional call of C7 on both packages: it binds as the reference binds it.
Nothing binds silently to another parameter.

The native plane's options (ROADMAP A6), once refused, are served by both
packages: each drives an echo through a native-plane server. So are the
policy options of ROADMAP A7 (``test_both_packages_serve_the_policy_
options``: admission limits, the idle reaper, credentials, the fault
injector, the data factories, the retry policy and backup requests), and
the positional calls of C7 that pass ``max_concurrency`` or
``backup_request_ms`` now bind on both packages. ``ChannelOptions(protocol=
"baidu_std")`` and ``"http"`` (ROADMAP A11a) are served by both packages
(``test_both_packages_serve_the_protocol_option``), and since ROADMAP A11b
so are hulu_pbrpc and sofa_pbrpc there, the other seven names of the
legacy family and ``ServerOptions(nshead_service=)``
(``test_both_packages_take_the_legacy_options``). Since ROADMAP A11d
``ServerOptions(thrift_service=)`` and ``mongo_service_adaptor=`` serve
their wires on both packages (``test_both_packages_serve_the_a11d_
server_options``), and a ``ChannelOptions(protocol="thrift")`` or
``"mongo"`` fails its call as the JAX channel's does, the registry rows
packing no request (``test_a11d_channel_protocols_fail_their_calls``).
Since ROADMAP A11e ``ServerOptions(rtmp_service=)`` serves the RTMP relay
on both packages (a publish-and-play round trip) and ``ChannelOptions(
protocol="rtmp")`` fails its call alike; both packages register the same
protocols in the same scan order, so the port has nothing left to refuse
(``test_unported_protocols_are_the_jax_packages``). And
``run_dispatch_session`` ends as the reference's does, ``..., chunk_order,
trace_id, parent_span_id`` (ROADMAP C8), with the port's ``device`` and
``group_timeout_s`` keyword-only after them; a non-zero trace id binds
there and places the session's step and chunk spans in that trace. Since
ROADMAP A10 ``ServerOptions(ssl_context=)`` and ``ChannelOptions(
ssl_context=)`` no longer refuse, and the port's ``Socket`` and
``Acceptor`` take the reference's TLS parameters, keyword-only
(tests/test_torch_ssl.py serves them)."""

import inspect
import socket
import struct
import threading
import time
import types

import pytest

import incubator_brpc_tpu.parallel.mc_dispatch as jax_mcd
import incubator_brpc_tpu.protocol.mongo as jax_mongo
import incubator_brpc_tpu.protocol.registry as jax_registry
import incubator_brpc_tpu.protocol.rtmp as jax_rtmp
import incubator_brpc_tpu.protocol.thrift as jax_thrift
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.server as jax_server_mod
import incubator_brpc_tpu.transport.acceptor as jax_acceptor
import incubator_brpc_tpu.transport.device_link as jax_dl
import incubator_brpc_tpu.transport.sock as jax_sock
import incubator_brpc_tpu.utils.flags as jax_flags
import incubator_brpc_tpu_torch.parallel.mc_dispatch as port_mcd
import incubator_brpc_tpu_torch.protocol.mongo as port_mongo
import incubator_brpc_tpu_torch.protocol.registry as port_registry
import incubator_brpc_tpu_torch.protocol.rtmp as port_rtmp
import incubator_brpc_tpu_torch.protocol.thrift as port_thrift
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.transport.acceptor as port_acceptor
import incubator_brpc_tpu_torch.transport.device_link as port_dl
import incubator_brpc_tpu_torch.transport.sock as port_sock
import incubator_brpc_tpu_torch.utils.flags as port_flags
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", ServerOptions=jax_server_mod.ServerOptions, rpc=jax_rpc,
        Acceptor=jax_acceptor.Acceptor, Socket=jax_sock.Socket,
        Protocol=jax_registry.Protocol, dl=jax_dl, server_kw={}, flags=jax_flags,
        thrift=jax_thrift, mongo=jax_mongo, rtmp=jax_rtmp,
    ),
    "torch": types.SimpleNamespace(
        name="torch", ServerOptions=port_rpc.ServerOptions, rpc=port_rpc,
        Acceptor=port_acceptor.Acceptor, Socket=port_sock.Socket,
        Protocol=port_registry.Protocol, dl=port_dl, server_kw={"device": "cpu"},
        flags=port_flags, thrift=port_thrift, mongo=port_mongo, rtmp=port_rtmp,
    ),
}

# the reference's parameters, in order (incubator_brpc_tpu/rpc/server.py:323,
# rpc/channel.py:252 and :346, rpc/controller.py:29, transport/device_link.py)
PUBLIC = {
    "ServerOptions": [
        "max_concurrency", "method_max_concurrency", "idle_timeout_s",
        "has_builtin_services", "auth", "usercode_inline", "device_index",
        "nshead_service", "thrift_service", "mongo_service_adaptor", "rtmp_service",
        "ssl_context", "native_plane", "native_loops", "num_reactors",
        "native_dispatch_workers", "session_local_data_factory",
        "reserved_session_local_data", "thread_local_data_factory",
        "reserved_thread_local_data", "enable_collective_service",
        "collective_max_concurrency", "fault_injector",
    ],
    "ChannelOptions": [
        "timeout_ms", "max_retry", "backup_request_ms", "connect_timeout", "protocol",
        "auth", "connection_type", "transport", "device_index", "link_slot_words",
        "link_window", "link_ack_mode", "link_controller", "native_plane",
        "ssl_context", "ssl_server_hostname", "retry_policy",
    ],
    "Controller": ["timeout_ms", "max_retry", "backup_request_ms", "log_id"],
    "Channel.init": ["self", "target", "lb_name", "options"],
    "DeviceLink": ["devices", "slot_words", "window", "host_loopback", "ack_mode"],
    "DeviceSocket": ["link", "side", "messenger", "user_message_handler", "context", "remote"],
}
# the port's keyword-only additions after the reference's parameters
PORT_KEYWORD_ONLY = {"ServerOptions": ["device"]}

INTERNAL = {
    "Acceptor": {
        "jax": ["endpoint", "messenger", "user_message_handler", "on_connection",
                "conn_context", "backlog", "inline_read", "ssl_context"],
        "torch": ["endpoint", "*", "messenger", "conn_context", "backlog", "inline_read",
                  "ssl_context"],
    },
    "Socket": {
        "jax": ["conn", "remote", "messenger", "is_client", "health_check_interval",
                "user_message_handler", "context", "inline_read", "preread",
                "ssl_context", "ssl_server_side", "ssl_server_hostname"],
        "torch": ["conn", "*", "remote", "messenger", "is_client", "context", "inline_read",
                  "preread", "ssl_context", "ssl_server_side", "ssl_server_hostname"],
    },
    "Protocol": {
        "jax": ["name", "parse", "parse_header", "pack_request", "pack_response",
                "process_request", "process_response", "process_stream", "parse_iobuf",
                "parse_conn", "enabled_for", "fifo_responses"],
        "torch": ["name", "*", "parse", "parse_header", "pack_request", "pack_response",
                  "process_request", "process_response", "process_stream", "parse_iobuf",
                  "parse_conn", "enabled_for", "fifo_responses"],
    },
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _public(pkg, name):
    return {
        "ServerOptions": pkg.ServerOptions,
        "ChannelOptions": pkg.rpc.ChannelOptions,
        "Controller": pkg.rpc.Controller,
        "Channel.init": pkg.rpc.Channel.init,
        "DeviceLink": pkg.dl.DeviceLink,
        "DeviceSocket": pkg.dl.DeviceSocket,
    }[name]


def _layout(fn):
    """Parameter names in order, with "*" before the first keyword-only."""
    out = []
    for p in inspect.signature(fn).parameters.values():
        if p.kind is p.KEYWORD_ONLY and "*" not in out:
            out.append("*")
        out.append(p.name)
    return out


@pytest.mark.parametrize("name", sorted(PUBLIC))
def test_public_signature_keeps_the_reference_order(pkg, name):
    want = list(PUBLIC[name])
    if pkg.name == "torch" and name in PORT_KEYWORD_ONLY:
        want += ["*"] + PORT_KEYWORD_ONLY[name]
    assert _layout(_public(pkg, name)) == want


@pytest.mark.parametrize("name", sorted(INTERNAL))
def test_internal_signature_cannot_misbind(pkg, name):
    fn = getattr(pkg, name)
    layout = _layout(fn)
    assert layout == INTERNAL[name][pkg.name]
    if pkg.name == "torch":
        # what may be passed by position is the reference's prefix, in its
        # places; every other name is one of the reference's, keyword-only
        ref = INTERNAL[name]["jax"]
        positional = layout[: layout.index("*")]
        assert positional == ref[: len(positional)]
        assert set(layout) - {"*"} <= set(ref)


def test_server_options_positional_four(pkg):
    opts = pkg.ServerOptions(4)
    assert opts.max_concurrency == 4
    assert opts.usercode_inline is False


def test_channel_options_positional_backup(pkg):
    opts = pkg.rpc.ChannelOptions(500, 3, 100)
    assert (opts.timeout_ms, opts.max_retry, opts.backup_request_ms) == (500, 3, 100)
    assert opts.connect_timeout == 5.0


def test_controller_positional_backup(pkg):
    cntl = pkg.rpc.Controller(500, 3, 50)
    assert (cntl.timeout_ms, cntl.max_retry, cntl.backup_request_ms) == (500, 3, 50)
    assert cntl.log_id == 0


def test_positional_defaults_bind_alike(pkg):
    """Positional calls that spell out the defaults bind the same values on
    both packages (the port serves them)."""
    cntl = pkg.rpc.Controller(500, 3, -1, 7)
    assert (cntl.timeout_ms, cntl.max_retry, cntl.log_id) == (500, 3, 7)
    opts = pkg.rpc.ChannelOptions(250, 1, -1, 2.0, "tbus_std", None, "single", "tpu", 0, 512, 4,
                                  "wire")
    assert (opts.timeout_ms, opts.max_retry, opts.connect_timeout) == (250, 1, 2.0)
    assert (opts.transport, opts.device_index, opts.link_slot_words, opts.link_window,
            opts.link_ack_mode) == ("tpu", 0, 512, 4, "wire")
    sopts = pkg.ServerOptions(0, 0, -1, True, None, True, 0)
    assert sopts.usercode_inline is True and sopts.device_index == 0


@pytest.fixture
def echo_server(pkg):
    srv = pkg.rpc.Server(pkg.ServerOptions(**pkg.server_kw))
    srv.add_service("Echo", {"echo": lambda cntl, req: req})
    assert srv.start(0)
    yield srv
    srv.stop()
    assert srv.join(timeout=10)
    if pkg.name == "torch":
        port_rpc.shutdown_host_plane()
        shutdown_global_timer_thread()  # the calls' timeouts started it


def test_init_with_empty_lb_name(pkg, echo_server):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{echo_server.port}", "") is True
    cntl = ch.call_method("Echo", "echo", b"after init(addr, '')")
    assert cntl.ok(), cntl.error_text
    assert cntl.response_payload == b"after init(addr, '')"


def test_init_with_lb_name_and_options(pkg, echo_server):
    # a plain ip:port with an lb_name stays one server, as in the reference
    opts = pkg.rpc.ChannelOptions(timeout_ms=1234)
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{echo_server.port}", "rr", opts) is True
    assert ch._options is opts and ch._lb is None
    assert ch.call_method("Echo", "echo", b"rr").response_payload == b"rr"


def test_unported_protocols_are_the_jax_packages():
    """No protocol is left unported: the port registers the JAX package's
    protocols, all of them, in its order, the order a new connection's scan
    tries them in."""
    jax_names = [p.name for p in jax_registry.protocol_registry.ordered()]
    port_names = [p.name for p in port_registry.protocol_registry.ordered()]
    assert port_names == jax_names


@pytest.mark.parametrize("protocol", ["baidu_std", "http", "hulu_pbrpc", "sofa_pbrpc"])
def test_both_packages_serve_the_protocol_option(protocol):
    """Once refused naming A11: both packages take the protocol and answer
    over it with the same payloads and codes."""
    for pkg in PKGS.values():
        srv = pkg.rpc.Server(pkg.ServerOptions(**pkg.server_kw))
        srv.add_service("Echo", {"echo": lambda cntl, req: req[::-1]})
        assert srv.start(0)
        try:
            opts = pkg.rpc.ChannelOptions(protocol=protocol)
            assert opts.protocol == protocol
            ch = pkg.rpc.Channel()
            assert ch.init(f"127.0.0.1:{srv.port}", options=opts)
            got = [ch.call_method("Echo", "echo", b"abc") for _ in range(3)]
            assert [(c.error_code, c.response_payload) for c in got] == [(0, b"cba")] * 3
            missing = ch.call_method("Echo", "nope", b"")
            assert missing.error_code == (ErrorCode.EHTTP if protocol == "http"
                                          else ErrorCode.ENOMETHOD), pkg.name
        finally:
            srv.stop()
            assert srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()


# the legacy family's options that refused naming A11 before A11b, less the
# two wires test_both_packages_serve_the_protocol_option calls over
LEGACY_TAKEN = ["nshead", "nshead_client", "nova_pbrpc", "public_pbrpc", "ubrpc_mcpack2",
                "nshead_mcpack", "esp", "nshead_service"]


@pytest.mark.parametrize("name", LEGACY_TAKEN)
def test_both_packages_take_the_legacy_options(name):
    """Once refused naming A11: both packages take the option. The FIFO
    wires and the nshead service answer in tests/test_torch_legacy_pbrpc.py
    and tests/test_torch_nshead.py; here a ``ServerOptions`` holds its
    service and a ``ChannelOptions`` its protocol, and a call over a row
    that packs no request fails the same way on both packages."""
    codes = {}
    for pkg in PKGS.values():
        if name == "nshead_service":
            def service(cntl, head, body):
                return body

            assert pkg.ServerOptions(nshead_service=service,
                                     **pkg.server_kw).nshead_service is service
            continue
        opts = pkg.rpc.ChannelOptions(protocol=name, timeout_ms=2000, max_retry=0)
        assert opts.protocol == name
        registry = jax_registry if pkg.name == "jax" else port_registry
        if registry.protocol_registry.get(name).pack_request is None:
            srv = pkg.rpc.Server(pkg.ServerOptions(**pkg.server_kw))
            srv.add_service("Echo", {"echo": lambda cntl, req: req})
            assert srv.start(0)
            try:
                ch = pkg.rpc.Channel()
                assert ch.init(f"127.0.0.1:{srv.port}", options=opts)
                cntl = ch.call_method("Echo", "echo", b"x")
                codes[pkg.name] = (cntl.error_code, cntl.error_text)
            finally:
                srv.stop()
                assert srv.join(timeout=10)
    if codes:
        assert codes["torch"] == codes["jax"]
        assert codes["torch"][0] == ErrorCode.EREQUEST
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()


def _serve_thrift(pkg, port):
    client = pkg.thrift.ThriftClient(f"127.0.0.1:{port}")
    try:
        return client.call("echo", b"abc")
    finally:
        client.close()


def _serve_mongo(pkg, port):
    mongo = pkg.mongo
    body = (struct.pack("<i", 0) + b"db.x\x00" + struct.pack("<ii", 0, 0)
            + mongo.bson_encode({"data": b"abc"}))
    with socket.create_connection(("127.0.0.1", port), timeout=10) as conn:
        conn.sendall(mongo.HEAD.pack(16 + len(body), 9, 0, mongo.OP_QUERY) + body)
        data = b""
        while len(data) < 4 or len(data) < struct.unpack_from("<i", data)[0]:
            data += conn.recv(65536)
    return mongo.bson_decode(data, 36)[0]["data"]


def _serve_rtmp(pkg, port):
    """A publish-and-play round trip: what the player receives of one
    audio frame."""
    got, done = [], threading.Event()

    def on_media(msg):
        got.append(msg.payload)
        done.set()

    player = pkg.rtmp.RtmpClient("127.0.0.1", port)
    pub = pkg.rtmp.RtmpClient("127.0.0.1", port)
    try:
        assert player.create_stream().play("sig", on_media=on_media)
        stream = pub.create_stream()
        assert stream.publish("sig")
        stream.send_audio(0, b"\xaf\x01cba")
        assert done.wait(10)
    finally:
        pub.close()
        player.close()
    return got[0][2:]


@pytest.mark.parametrize("option", ["thrift_service", "mongo_service_adaptor", "rtmp_service"])
def test_both_packages_serve_the_a11d_server_options(pkg, option):
    """Once refused naming A11d (A11e for ``rtmp_service``): the option is
    taken, held, and serves its wire on the server's port beside
    tbus_std."""
    if option == "thrift_service":
        def value(cntl, method, payload):
            return payload[::-1]
    elif option == "mongo_service_adaptor":
        class Adaptor(pkg.mongo.MongoServiceAdaptor):
            def handle_query(self, ctx, query):
                return [{"data": query.query["data"][::-1]}]

        value = Adaptor()
    else:
        value = pkg.rtmp.RtmpService()
    opts = pkg.ServerOptions(**{option: value}, **pkg.server_kw)
    assert getattr(opts, option) is value
    srv = pkg.rpc.Server(opts)
    srv.add_service("Echo", {"echo": lambda cntl, req: req})
    assert srv.start(0)
    try:
        serve = {"thrift_service": _serve_thrift, "mongo_service_adaptor": _serve_mongo,
                 "rtmp_service": _serve_rtmp}[option]
        assert serve(pkg, srv.port) == b"cba"
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}")
        assert ch.call_method("Echo", "echo", b"tbus").response_payload == b"tbus"
    finally:
        srv.stop()
        assert srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()


@pytest.mark.parametrize("protocol", ["thrift", "mongo", "rtmp"])
def test_a11d_channel_protocols_fail_their_calls(pkg, protocol):
    """Once refused naming A11d (A11e for rtmp): the option is taken, and a
    call over it fails as the JAX channel's does, the registry's row
    packing no request."""
    opts = pkg.rpc.ChannelOptions(protocol=protocol, timeout_ms=2000, max_retry=0)
    assert opts.protocol == protocol
    srv = pkg.rpc.Server(pkg.ServerOptions(**pkg.server_kw))
    srv.add_service("Echo", {"echo": lambda cntl, req: req})
    assert srv.start(0)
    try:
        ch = pkg.rpc.Channel()
        assert ch.init(f"127.0.0.1:{srv.port}", options=opts)
        cntl = ch.call_method("Echo", "echo", b"x")
        assert (cntl.error_code, cntl.error_text) == (
            ErrorCode.EREQUEST, f"pack failed: protocol {protocol!r} cannot pack requests")
    finally:
        srv.stop()
        assert srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()


@pytest.mark.parametrize("ctype", ["pooled", "short"])
def test_both_packages_serve_the_connection_type(ctype):
    """Once refused naming A8: both packages now take and serve it."""
    for pkg in PKGS.values():
        srv = pkg.rpc.Server(pkg.ServerOptions(**pkg.server_kw))
        srv.add_service("Echo", {"echo": lambda cntl, req: req})
        assert srv.start(0)
        try:
            opts = pkg.rpc.ChannelOptions(connection_type=ctype)
            assert opts.connection_type == ctype
            ch = pkg.rpc.Channel()
            assert ch.init(f"127.0.0.1:{srv.port}", options=opts)
            for i in range(3):
                cntl = ch.call_method("Echo", "echo", b"%s %d" % (ctype.encode(), i))
                assert cntl.ok(), cntl.error_text
                assert cntl.response_payload == b"%s %d" % (ctype.encode(), i)
        finally:
            srv.stop()
            assert srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()


def _policy_server(pkg, handlers, **opts):
    srv = pkg.rpc.Server(pkg.ServerOptions(**opts, **pkg.server_kw))
    srv.add_service("P", handlers)
    assert srv.start(0)
    return srv


def _policy_channel(pkg, port, **opts):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{port}", options=pkg.rpc.ChannelOptions(**opts))
    return ch


def _held_then_second(pkg, make_server, second):
    """Hold one call in a gated handler, then make ``second`` (a function
    of the channel): the codes of the held call and of the second."""
    gate = threading.Event()
    entered = threading.Event()

    def hold(cntl, req):
        entered.set()
        gate.wait(10)
        return b"held"

    srv = make_server({"hold": hold, "echo": lambda cntl, req: req})
    try:
        ch = _policy_channel(pkg, srv.port, timeout_ms=10000, max_retry=0)
        held = []
        t = threading.Thread(target=lambda: held.append(ch.call_method("P", "hold", b"")))
        t.start()
        try:
            assert entered.wait(10)
            code = second(ch)
        finally:
            gate.set()
            t.join(10)
        return [held[0].error_code, code]
    finally:
        srv.stop()
        assert srv.join(timeout=10)


def _drive_max_concurrency(pkg):
    return _held_then_second(pkg, lambda h: _policy_server(pkg, h, max_concurrency=1),
                             lambda ch: ch.call_method("P", "echo", b"x").error_code)


def _drive_method_max_concurrency(pkg):
    return _held_then_second(pkg, lambda h: _policy_server(pkg, h, method_max_concurrency=1),
                             lambda ch: ch.call_method("P", "hold", b"").error_code)


def _drive_idle_timeout(pkg):
    srv = _policy_server(pkg, {"echo": lambda cntl, req: req}, idle_timeout_s=0.2)
    try:
        ch = _policy_channel(pkg, srv.port)
        codes = [ch.call_method("P", "echo", b"x").error_code]
        deadline = time.monotonic() + 20
        while srv.connection_count() and time.monotonic() < deadline:
            time.sleep(0.02)
        codes.append(srv.connection_count())
        return codes
    finally:
        srv.stop()
        assert srv.join(timeout=10)


def _drive_auth(pkg):
    tok = pkg.rpc.TokenAuthenticator(["right"])
    srv = _policy_server(pkg, {"echo": lambda cntl, req: req}, auth=tok)
    try:
        return [
            _policy_channel(pkg, srv.port, auth=pkg.rpc.TokenAuthenticator("right"))
            .call_method("P", "echo", b"x").error_code,
            _policy_channel(pkg, srv.port).call_method("P", "echo", b"x").error_code,
        ]
    finally:
        srv.stop()
        assert srv.join(timeout=10)


def _drive_data_factory(pkg, option):
    made = []

    def factory():
        made.append(object())
        return made[-1]

    def use(cntl, req):
        if option == "session_local_data_factory":
            data = cntl.session_local_data()
        else:
            data = pkg.rpc.thread_local_data()
        return b"%d" % made.index(data)

    srv = _policy_server(pkg, {"use": use}, **{option: factory})
    try:
        ch = _policy_channel(pkg, srv.port)
        return [ch.call_method("P", "use", b"").response_payload for _ in range(3)]
    finally:
        srv.stop()
        assert srv.join(timeout=10)


def _drive_fault_injector(pkg):
    before = pkg.flags.get_flag("fault_injection")
    pkg.flags.set_flag_unchecked("fault_injection", True)
    try:
        inj = pkg.rpc.FaultInjector(error_rate=0.5)
        srv = _policy_server(pkg, {"echo": lambda cntl, req: req}, fault_injector=inj)
        try:
            ch = _policy_channel(pkg, srv.port, max_retry=0)
            return [ch.call_method("P", "echo", b"x").error_code for _ in range(4)]
        finally:
            srv.stop()
            assert srv.join(timeout=10)
    finally:
        pkg.flags.set_flag_unchecked("fault_injection", before)


def _drive_retry_policy(pkg):
    calls = []

    def flaky(cntl, req):
        calls.append(1)
        if len(calls) < 3:
            cntl.set_failed(ErrorCode.EINTERNAL, "transient")
            return b""
        return req

    srv = _policy_server(pkg, {"m": flaky})
    try:
        ch = _policy_channel(pkg, srv.port, max_retry=3,
                             retry_policy=lambda c: c.error_code == ErrorCode.EINTERNAL)
        out = ch.call_method("P", "m", b"b")
        return [out.error_code, out.retried_count, len(calls)]
    finally:
        srv.stop()
        assert srv.join(timeout=10)


def _drive_backup(pkg, where):
    """The original attempt waits on a gate released only once the call
    returned: the backup fired on its timer and its reply won."""
    gate = threading.Event()
    seen = []

    def handler(cntl, req):
        seen.append(1)
        if len(seen) == 1:
            gate.wait(10)
            return b"original"
        return b"backup"

    srv = _policy_server(pkg, {"m": handler})
    try:
        if where == "channel":
            ch = _policy_channel(pkg, srv.port, timeout_ms=8000, backup_request_ms=50)
            cntl = ch.call_method("P", "m", b"")
        else:
            ch = _policy_channel(pkg, srv.port)
            cntl = ch.call_method("P", "m", b"", cntl=pkg.rpc.Controller(8000, 3, 50))
        return [cntl.error_code, cntl.response_payload, cntl.has_backup_request]
    finally:
        gate.set()
        srv.stop()
        assert srv.join(timeout=10)


# each option that refused naming A7 before it landed, driven on both
# packages, and what both must answer
POLICY_OPTIONS = {
    "ServerOptions.max_concurrency": (_drive_max_concurrency, [0, ErrorCode.ELIMIT]),
    "ServerOptions.method_max_concurrency": (_drive_method_max_concurrency, [0, ErrorCode.ELIMIT]),
    "ServerOptions.idle_timeout_s": (_drive_idle_timeout, [0, 0]),
    "ServerOptions.auth+ChannelOptions.auth": (_drive_auth, [0, ErrorCode.ERPCAUTH]),
    "ServerOptions.session_local_data_factory": (
        lambda pkg: _drive_data_factory(pkg, "session_local_data_factory"), [b"0", b"0", b"0"]),
    "ServerOptions.thread_local_data_factory": (
        lambda pkg: _drive_data_factory(pkg, "thread_local_data_factory")[:1], [b"0"]),
    "ServerOptions.fault_injector": (
        _drive_fault_injector, [0, ErrorCode.EINTERNAL, 0, ErrorCode.EINTERNAL]),
    "ChannelOptions.retry_policy": (_drive_retry_policy, [0, 2, 3]),
    "ChannelOptions.backup_request_ms": (
        lambda pkg: _drive_backup(pkg, "channel"), [0, b"backup", True]),
    "Controller.backup_request_ms": (
        lambda pkg: _drive_backup(pkg, "controller"), [0, b"backup", True]),
}


@pytest.mark.parametrize("option", sorted(POLICY_OPTIONS))
def test_both_packages_serve_the_policy_options(option):
    """Once refused naming A7: both packages take and serve the option,
    with the same answers."""
    drive, want = POLICY_OPTIONS[option]
    for pkg in PKGS.values():
        assert drive(pkg) == want, pkg.name
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()


def test_port_refuses_values_the_reference_refuses():
    for kw in ({"transport": "rdma"}, {"connection_type": "udp"}, {"link_controller": "x"},
               {"transport": "tpu", "connection_type": "pooled"}):
        with pytest.raises(ValueError):
            jax_rpc.ChannelOptions(**kw)
        with pytest.raises(ValueError):
            port_rpc.ChannelOptions(**kw)


def test_both_packages_take_the_multi_controller_link():
    """Once refused naming A4: both packages take ``link_controller="multi"``
    (the port's link half over torch.distributed, transport/mc_link.py)."""
    for pkg in PKGS.values():
        opts = pkg.rpc.ChannelOptions(transport="tpu", link_controller="multi")
        assert opts.link_controller == "multi"


@pytest.mark.parametrize("kw", [{"enable_collective_service": True},
                                {"collective_max_concurrency": 4},
                                {"enable_collective_service": True,
                                 "collective_max_concurrency": 0}],
                         ids=["enable", "max_concurrency", "both"])
def test_both_packages_take_the_collective_service_options(pkg, kw):
    """Once refused naming A4 (then A4b): both packages take the options of
    the collective services and keep them on the options object."""
    opts = pkg.ServerOptions(**kw)
    for name, value in kw.items():
        assert getattr(opts, name) == value


def test_has_builtin_services_is_accepted_either_way():
    for value in (True, False):
        assert port_rpc.ServerOptions(has_builtin_services=value).has_builtin_services is value


# the native plane's options, once refused naming A6: (owner, kwargs)
NATIVE_SERVED = [
    ("ServerOptions", {"native_plane": True}),
    ("ServerOptions", {"native_plane": True, "num_reactors": 2}),
    ("ServerOptions", {"native_plane": True, "native_loops": 2}),
    ("ServerOptions", {"native_plane": True, "native_dispatch_workers": 2}),
    ("ChannelOptions", {"native_plane": True}),
]


@pytest.mark.parametrize("owner,kw", NATIVE_SERVED,
                         ids=[f"{o}-{'-'.join(k)}" for o, k in NATIVE_SERVED])
def test_both_packages_serve_the_native_plane_options(owner, kw):
    for pkg in PKGS.values():
        skw = kw if owner == "ServerOptions" else {"native_plane": True}
        sopts = pkg.ServerOptions(**skw, **pkg.server_kw)
        for name, value in skw.items():
            assert getattr(sopts, name) == value
        if "native_loops" in skw:
            assert sopts.num_reactors == skw["native_loops"]  # the live alias
        copts = pkg.rpc.ChannelOptions(**(kw if owner == "ChannelOptions" else {}))
        srv = pkg.rpc.Server(sopts)
        srv.add_service("Echo", {"echo": pkg.rpc.native_echo, "py": lambda cntl, req: req[::-1]})
        assert srv.start(0)
        try:
            plane = srv._native_plane
            assert plane is not None, pkg.name
            assert plane.num_reactors == (sopts.num_reactors or plane.num_reactors)
            assert plane.native_method_names() == ["Echo.echo"]
            ch = pkg.rpc.Channel()
            assert ch.init(f"127.0.0.1:{srv.port}", options=copts)
            for method, want in (("echo", b"native"), ("py", b"evitan")):
                cntl = ch.call_method("Echo", method, b"native")
                assert cntl.ok(), cntl.error_text
                assert cntl.response_payload == want
            if owner == "ChannelOptions":
                assert ch._native_ch is not None  # the call rode the native client
        finally:
            srv.stop()
            assert srv.join(timeout=10)
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()


# run_dispatch_session's parameters in the reference's order
# (incubator_brpc_tpu/parallel/mc_dispatch.py:1020-1041)
SESSION_PARAMS = [
    "party_ids", "own_index", "dm", "operands", "steps", "service", "method",
    "should_abort", "session_id", "resume_from", "resume_state", "checkpoint_every",
    "step_deadline_ms", "session_epoch", "chunks", "double_buffer", "quantize",
    "chunk_order", "trace_id", "parent_span_id",
]


def test_run_dispatch_session_keeps_the_reference_order(pkg):
    mcd = jax_mcd if pkg.name == "jax" else port_mcd
    want = list(SESSION_PARAMS)
    if pkg.name == "torch":
        want += ["*", "device", "group_timeout_s"]
    assert _layout(mcd.run_dispatch_session) == want


def test_run_dispatch_session_refuses_a_trace_naming_a12():
    """The reference's positional tail binds trace_id and parent_span_id:
    the session runs, and its step and chunk spans land in that trace."""
    from incubator_brpc_tpu_torch.builtin.rpcz import span_store
    from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod

    dm = DeviceMethod(lambda x, ns, axis: (x, ns), width=4)
    ops = [b"\1" * 4, b"\2" * 4]
    # double_buffer on (one chunk): the overlapped chain, which opens spans
    args = ([0, 1], 0, dm, ops, 2, "s", "m", None, None, 0, None, 0, 0.0, 0, 1, True,
            "none", None, 7, 9)
    saved = {k: port_flags.flag_registry.get(k) for k in ("enable_rpcz", "rpcz_samples_per_second")}
    port_flags.set_flag_unchecked("enable_rpcz", True)
    port_flags.set_flag_unchecked("rpcz_samples_per_second", 10_000_000)
    span_store.clear()
    try:
        row, n, _elapsed = port_mcd.run_dispatch_session(*args, device="cpu")
        spans = span_store.by_trace(7)
    finally:
        for k, v in saved.items():
            port_flags.set_flag_unchecked(k, v)
        span_store.clear()
    assert bytes(row[:4]) == b"\1" * 4 and n == 4
    steps = [sp for sp in spans if sp.annotations[0][1].startswith("compute step=")]
    chunks = [sp for sp in spans if sp.annotations[0][1].startswith("chunk=")]
    assert [sp.parent_span_id for sp in steps] == [9, 9]
    assert sorted(sp.parent_span_id for sp in chunks) == sorted(sp.span_id for sp in steps)
