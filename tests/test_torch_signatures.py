"""Public and internal signatures of the port's host plane against the JAX
package's, parametrised over both packages (ROADMAP C7).

The port keeps the reference's parameters in the reference's places in
``ServerOptions``, ``ChannelOptions``, ``Controller``, ``Channel.init`` and
the link classes ``DeviceLink``/``DeviceSocket``, adding only a keyword-only
``device`` after them where it needs one. The internal ``Acceptor``,
``Socket`` and ``Protocol`` drop reference parameters, so every parameter
after the first of them that may be passed by position is keyword-only. The
tests pin each signature's names and order with ``inspect``, and run each
positional call of C7 on both packages: it binds as the reference binds it,
or the port refuses it with a message that names the ROADMAP item that
brings the parameter. Nothing binds silently to another parameter."""

import inspect
import types

import pytest

import incubator_brpc_tpu.protocol.registry as jax_registry
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.server as jax_server_mod
import incubator_brpc_tpu.transport.acceptor as jax_acceptor
import incubator_brpc_tpu.transport.device_link as jax_dl
import incubator_brpc_tpu.transport.sock as jax_sock
import incubator_brpc_tpu_torch.protocol.registry as port_registry
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.transport.acceptor as port_acceptor
import incubator_brpc_tpu_torch.transport.device_link as port_dl
import incubator_brpc_tpu_torch.transport.sock as port_sock

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", ServerOptions=jax_server_mod.ServerOptions, rpc=jax_rpc,
        Acceptor=jax_acceptor.Acceptor, Socket=jax_sock.Socket,
        Protocol=jax_registry.Protocol, dl=jax_dl, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", ServerOptions=port_rpc.ServerOptions, rpc=port_rpc,
        Acceptor=port_acceptor.Acceptor, Socket=port_sock.Socket,
        Protocol=port_registry.Protocol, dl=port_dl, server_kw={"device": "cpu"},
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
        "torch": ["endpoint", "*", "messenger", "conn_context", "backlog", "inline_read"],
    },
    "Socket": {
        "jax": ["conn", "remote", "messenger", "is_client", "health_check_interval",
                "user_message_handler", "context", "inline_read", "preread",
                "ssl_context", "ssl_server_side", "ssl_server_hostname"],
        "torch": ["conn", "*", "remote", "messenger", "is_client", "context", "inline_read"],
    },
    "Protocol": {
        "jax": ["name", "parse", "parse_header", "pack_request", "pack_response",
                "process_request", "process_response", "process_stream", "parse_iobuf",
                "parse_conn", "enabled_for", "fifo_responses"],
        "torch": ["name", "*", "parse", "parse_header", "process_request",
                  "process_response"],
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


def _call(fn):
    """fn() -> (result, None), or (None, the NotImplementedError raised)."""
    try:
        return fn(), None
    except NotImplementedError as e:
        return None, e


def test_server_options_positional_four(pkg):
    opts, err = _call(lambda: pkg.ServerOptions(4))
    if err is not None:
        assert pkg.name == "torch" and "max_concurrency" in str(err) and "A7" in str(err)
    else:
        assert opts.max_concurrency == 4
        assert opts.usercode_inline is False


def test_channel_options_positional_backup(pkg):
    opts, err = _call(lambda: pkg.rpc.ChannelOptions(500, 3, 100))
    if err is not None:
        assert pkg.name == "torch" and "backup_request_ms" in str(err) and "A7" in str(err)
    else:
        assert (opts.timeout_ms, opts.max_retry, opts.backup_request_ms) == (500, 3, 100)
        assert opts.connect_timeout == 5.0


def test_controller_positional_backup(pkg):
    cntl, err = _call(lambda: pkg.rpc.Controller(500, 3, 50))
    if err is not None:
        assert pkg.name == "torch" and "backup_request_ms" in str(err) and "A7" in str(err)
    else:
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


# each unported option value and the ROADMAP item its refusal names
REFUSED = [
    ("ServerOptions", {"method_max_concurrency": 2}, "A7"),
    ("ServerOptions", {"idle_timeout_s": 30}, "A7"),
    ("ServerOptions", {"auth": object()}, "A7"),
    ("ServerOptions", {"nshead_service": print}, "A11"),
    ("ServerOptions", {"thrift_service": print}, "A11"),
    ("ServerOptions", {"mongo_service_adaptor": object()}, "A11"),
    ("ServerOptions", {"rtmp_service": object()}, "A11"),
    ("ServerOptions", {"ssl_context": object()}, "A10"),
    ("ServerOptions", {"native_plane": True}, "A6"),
    ("ServerOptions", {"num_reactors": 2}, "A6"),
    ("ServerOptions", {"native_loops": 2}, "A6"),
    ("ServerOptions", {"native_dispatch_workers": 2}, "A6"),
    ("ServerOptions", {"session_local_data_factory": dict}, "A7"),
    ("ServerOptions", {"thread_local_data_factory": dict}, "A7"),
    ("ServerOptions", {"enable_collective_service": True}, "A4"),
    ("ServerOptions", {"collective_max_concurrency": 4}, "A4"),
    ("ServerOptions", {"fault_injector": object()}, "A7"),
    ("ChannelOptions", {"protocol": "baidu_std"}, "A11"),
    ("ChannelOptions", {"auth": object()}, "A7"),
    ("ChannelOptions", {"link_controller": "multi"}, "A4"),
    ("ChannelOptions", {"native_plane": True}, "A6"),
    ("ChannelOptions", {"ssl_context": object()}, "A10"),
    ("ChannelOptions", {"retry_policy": lambda cntl: True}, "A7"),
]


@pytest.mark.parametrize("owner,kw,item", REFUSED,
                         ids=[f"{o}-{next(iter(k))}-{v}" for o, k, v in REFUSED])
def test_port_refuses_unported_values_naming_the_item(owner, kw, item):
    cls = port_rpc.ServerOptions if owner == "ServerOptions" else port_rpc.ChannelOptions
    name = next(iter(kw))
    with pytest.raises(NotImplementedError, match=rf"{name}=.*ROADMAP {item}\b"):
        cls(**kw)


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


def test_port_refuses_values_the_reference_refuses():
    for kw in ({"transport": "rdma"}, {"connection_type": "udp"}, {"link_controller": "x"},
               {"transport": "tpu", "connection_type": "pooled"}):
        with pytest.raises(ValueError):
            jax_rpc.ChannelOptions(**kw)
        with pytest.raises(ValueError):
            port_rpc.ChannelOptions(**kw)


def test_has_builtin_services_is_accepted_either_way():
    for value in (True, False):
        assert port_rpc.ServerOptions(has_builtin_services=value).has_builtin_services is value
