"""nshead (``protocol/nshead.py``) and the protocol scan's option gate
(``Protocol.enabled_for``) of the port on the CPU, held against the JAX
package's:

- the three ``TestNshead`` cases of ``tests/test_watch_nshead.py`` on both
  packages (the 36-byte head and its magic at byte 24, the incomplete and
  foreign cuts, nshead multiplexed on a tbus_std port);
- the head byte for byte: seeded ids, versions, log ids, providers,
  reserved words and bodies pack to the same frames in both packages, and
  each package's cut and header sizing read the other's alike, at every
  prefix length;
- the gate: both registries hold the same protocols with a gate, and each
  gate answers the same on the same connections (a server with and without
  an ``nshead_service``, a client socket tagged with each FIFO protocol);
  the handler's thread sees its server (``thread_local_data``).

The port's servers run on ``ServerOptions(device="cpu")``. After each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of bytes, integers or strings."""

from __future__ import annotations

import socket as pysocket
import struct
import threading
import types

import numpy as np
import pytest

import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import nshead as jax_nshead
from incubator_brpc_tpu.protocol import registry as jax_registry
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.rpc import server as jax_server
from incubator_brpc_tpu_torch.protocol import nshead as port_nshead
from incubator_brpc_tpu_torch.protocol import registry as port_registry
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.rpc import server as port_server
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, nshead=jax_nshead,
                                 ParseError=jax_tbus.ParseError, server=jax_server,
                                 server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, nshead=port_nshead,
                                   ParseError=port_tbus.ParseError, server=port_server,
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


def read_nshead(pkg, conn):
    buf = b""
    while True:
        chunk = conn.recv(65536)
        assert chunk, "connection closed before the response"
        buf += chunk
        frame, consumed = pkg.nshead.try_parse_frame(buf)
        if frame is not None:
            return frame


# -- tests/test_watch_nshead.py's TestNshead on both packages ----------------


class TestNshead:
    def test_frame_roundtrip_and_header_layout(self, pkg):
        wire = pkg.nshead.pack_frame(b"body!", id=3, version=1, log_id=77)
        assert len(wire) == 36 + 5
        # magic at byte 24 (2+2+4+16 preceding bytes), little-endian
        assert struct.unpack_from("<I", wire, 24)[0] == 0xFB709394
        frame, consumed = pkg.nshead.try_parse_frame(wire)
        assert consumed == len(wire)
        assert frame.head["id"] == 3
        assert frame.head["log_id"] == 77
        assert frame.payload == b"body!"

    def test_incomplete_and_foreign(self, pkg):
        wire = pkg.nshead.pack_frame(b"x" * 10)
        for cut in (0, 20, 35, 40):
            assert pkg.nshead.try_parse_frame(wire[:cut]) == (None, 0)
        with pytest.raises(pkg.ParseError):
            pkg.nshead.try_parse_frame(b"Z" * 40)

    def test_nshead_multiplexes_on_tbus_port(self, pkg):
        # one server, one port: tbus_std echo AND nshead frames both served
        def ns_handler(cntl, head, body):
            return b"ns:" + body + b":" + str(head["log_id"]).encode()

        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(nshead_service=ns_handler, **pkg.server_kw))
        srv.add_service("t", {"echo": lambda cntl, req: req})
        assert srv.start(0)
        try:
            # binary tbus call
            ch = pkg.rpc.Channel()
            assert ch.init(f"127.0.0.1:{srv.port}")
            assert ch.call_method("t", "echo", b"tbus-ok").ok()
            # raw nshead call on the same port
            c = pysocket.create_connection(("127.0.0.1", srv.port))
            c.settimeout(5)
            c.sendall(pkg.nshead.pack_frame(b"legacy", id=9, log_id=42))
            frame = read_nshead(pkg, c)
            assert frame.payload == b"ns:legacy:42"
            assert frame.head["id"] == 9
            c.close()
            # and tbus still works afterwards
            assert ch.call_method("t", "echo", b"still-ok").ok()
        finally:
            srv.stop()
            srv.join(timeout=5)


# -- the head byte for byte ----------------------------------------------------


def test_frames_identical_across_packages():
    rng = np.random.default_rng(32)
    for _ in range(50):
        body = rng.integers(0, 256, int(rng.choice([0, 1, 35, 36, 1000])), dtype=np.uint8).tobytes()
        head = dict(id=int(rng.integers(0, 1 << 17)), version=int(rng.integers(0, 1 << 17)),
                    log_id=int(rng.integers(0, 1 << 33)),
                    provider=rng.integers(1, 256, int(rng.integers(0, 20)), dtype=np.uint8).tobytes(),
                    reserved=int(rng.integers(0, 1 << 33)))
        wire = jax_nshead.pack_frame(body, **head)
        assert port_nshead.pack_frame(body, **head) == wire
        for cut in sorted({0, 8, 27, 28, 35, 36, len(wire) - 1, len(wire)}):
            part = wire[:max(0, cut)]
            assert port_nshead.parse_header(part[:36]) == jax_nshead.parse_header(part[:36])
            jf, jn = jax_nshead.try_parse_frame(part)
            pf, pn = port_nshead.try_parse_frame(part)
            assert pn == jn
            assert (pf is None) == (jf is None)
            if jf is not None:
                assert (pf.head, pf.payload) == (jf.head, jf.payload)


# -- the gate ---------------------------------------------------------------


class _Options:
    def __init__(self, nshead_service=None):
        self.nshead_service = nshead_service


class _Sock:
    def __init__(self, context):
        self.context = context


def _gate_answers(registry):
    services = {"none": None, "nshead": lambda cntl, head, body: body}
    socks = {f"server-{k}": _Sock({"server": types.SimpleNamespace(options=_Options(v))})
             for k, v in services.items()}
    socks["client-untagged"] = _Sock({})
    for proto in ("nova_pbrpc", "public_pbrpc", "ubrpc_mcpack2", "nshead_mcpack", "esp", "http"):
        socks[f"client-{proto}"] = _Sock({"fifo_protocol": proto})
    return {p.name: {label: bool(p.enabled_for(s)) for label, s in socks.items()}
            for p in registry.protocol_registry.ordered() if p.enabled_for is not None}


def test_gates_answer_like_the_jax_packages():
    port = _gate_answers(port_registry)
    jax = _gate_answers(jax_registry)
    assert set(port) == {"nshead", "mongo", "thrift", "rtmp", "nshead_client", "esp"}
    assert port == {name: rows for name, rows in jax.items() if name in port}
    assert port["nshead"]["server-nshead"] and not port["nshead"]["server-none"]


def test_nshead_handler_sees_its_server(pkg):
    """The nshead handler runs with the server's thread-local data set,
    as a method of the method map does."""
    seen = []

    def ns_handler(cntl, head, body):
        seen.append(pkg.server._usercode_tls.server)
        return body

    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(nshead_service=ns_handler, **pkg.server_kw))
    assert srv.start(0)
    try:
        with pysocket.create_connection(("127.0.0.1", srv.port), timeout=10) as c:
            c.sendall(pkg.nshead.pack_frame(b"who", id=1))
            assert read_nshead(pkg, c).payload == b"who"
        assert seen == [srv]
    finally:
        srv.stop()
        srv.join(timeout=5)
