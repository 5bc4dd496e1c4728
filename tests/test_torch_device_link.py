"""The port's two-party device link (``incubator_brpc_tpu_torch.transport.
device_link``, ``ChannelOptions(transport="tpu")``) on the CPU, held against
the JAX package's:

- the 24 tests of tests/test_device_link.py that the port covers —
  ``TestDeviceEcho`` (5), ``TestContentionAndFlowControl`` (3),
  ``TestTeardown`` (3), ``TestHostLoopbackFastPath`` (4),
  ``TestWireAckWindow`` (4), ``test_link_map_dedupes_links_across_channels``,
  ``test_link_map_isolates_credentials`` (ROADMAP A7),
  ``TestStepFailureInjection`` and ``TestZeroCopyDelivery`` (2) — each run on
  both packages with the answers the JAX package's own tests assert. The
  port's servers are built with ``ServerOptions(device="cpu")``: one device,
  so its links take the host swap where the JAX package's, on the
  conftest's 8 virtual devices, run the ``ppermute`` step. The port's
  forced device form (``host_loopback=False``) is reached deliberately:
  ``TestHostLoopbackFastPath`` builds it directly, and
  ``TestStepFailureInjection`` patches the module's ``DeviceLink`` so the
  handshake builds it;
- the forced device form streaming in both ack modes;
- slot parity: one seeded sequence of sends (frames spanning slots, an
  IOBuf send, a close) through both packages' ``DeviceLink`` in the host
  swap, in ``ack_mode`` "local" and "wire": every slot row's header words
  and payload bytes are byte-identical between the packages;
- ``device_method()``'s handler against the JAX package's on the same
  requests (a byte-XOR kernel and a length-changing one), bitwise;
- device RPC over the link: ``DeviceEndpoint(device="cpu").server_handler()``
  on the port's Server, called through ``transport="tpu"``, answers with the
  bytes the JAX package's endpoint answers over its own link (the echo table
  and methods {0: echo, 3: x2, 5: +10}, ENOMETHOD for an unknown id), and
  16 threads x 8 calls all succeed with ``fiber_concurrency`` 4 (handlers
  parked on the endpoint during a link delivery do not hold the pool);
- a server with an authenticator: a link channel with the right
  credential completes its handshake and calls over the link, and one
  without is refused with ERPCAUTH, on both packages;
- ``schedule_session_order`` against the JAX package's on a table of
  link profiles (empty, one measured link, ties, unmeasured entries,
  ``chunks`` > 1): identical orders and notes; and ``link_profile()`` of a
  live link.

Of the other 7 tests of tests/test_device_link.py,
``test_partition_channel_over_device_links`` and
``test_lb_target_with_tpu_transport`` run on both packages in
tests/test_torch_combo.py (A8 and the combo channels' host form). The rest
wait for a later item: ``TestDynamicPartitionFused``,
``TestCollectiveLowering`` (2) and ``test_fused_falls_back_when_one_link_is_dead``
the fused collective lowering over the mesh (A3c).

Each test stops the servers it started, and after each the port's host
plane is shut down and no ``tbtorch-*`` thread is left."""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sys

import incubator_brpc_tpu.iobuf as jax_iobuf
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.server as jax_server_mod
from incubator_brpc_tpu.models.tensor_echo import TensorEchoService as JaxService
from incubator_brpc_tpu.parallel import mc_dispatch as jax_mcd
from incubator_brpc_tpu.transport import device_link as jax_dl
from incubator_brpc_tpu.transport.device import DeviceEndpoint as JaxEndpoint
import incubator_brpc_tpu_torch.iobuf as port_iobuf
import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService
from incubator_brpc_tpu_torch.ops import kernels
from incubator_brpc_tpu_torch.parallel import mc_dispatch as port_mcd
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport import device_link as port_dl
from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, ServerOptions=jax_server_mod.ServerOptions,
        dl=jax_dl, IOBuf=jax_iobuf.IOBuf, server_kw={}, peer_index=1,
        shared_device=lambda: jax.devices()[0],
        link_pair=lambda: (jax.devices()[:2] if len(jax.devices()) >= 2
                           else [jax.devices()[0]] * 2),
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, ServerOptions=port_rpc.ServerOptions,
        dl=port_dl, IOBuf=port_iobuf.IOBuf, server_kw={"device": "cpu"}, peer_index=0,
        shared_device=lambda: torch.device("cpu"),
        link_pair=lambda: [torch.device("cpu")] * 2,
    ),
}

_OPEN = []  # servers and endpoints the test started, closed at teardown


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        obj = _OPEN.pop()
        if isinstance(obj, DeviceEndpoint):
            assert obj.close(timeout=60)
        elif not isinstance(obj, JaxEndpoint):
            obj.stop()
            assert obj.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def make_server(pkg, services, **opts):
    srv = pkg.rpc.Server(pkg.ServerOptions(**opts, **pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


@pytest.fixture
def echo_server(pkg):
    def echo(cntl, req):
        cntl.response_attachment = cntl.request_attachment
        return req

    return make_server(pkg, {"EchoService": {"Echo": echo}})


def _tpu_channel(pkg, server, timeout_ms=30000, **opts):
    ch = pkg.rpc.Channel()
    assert ch.init(
        f"127.0.0.1:{server.port}",
        options=pkg.rpc.ChannelOptions(transport="tpu", timeout_ms=timeout_ms, **opts),
    )
    return ch


def _target(ch):
    """The channel's server endpoint (the packages name the field apart)."""
    return getattr(ch, "_single_server", None) or ch._server


class TestDeviceEcho:
    def test_echo_roundtrip_crosses_two_devices(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        cntl = ch.call_method("EchoService", "Echo", b"over the device plane")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"over the device plane"
        ds = ch._device_sock
        assert ds is not None
        if pkg.name == "jax":
            if len(jax.devices()) > 1:
                # the two halves really sit on different mesh devices
                assert ds.link.devices[0] != ds.link.devices[1]
                assert ds.link._mesh is not None  # shard_map/ppermute path
        else:
            # one CPU device: both halves share it, and the link takes the
            # host swap by default
            assert ds.link.devices == [torch.device("cpu")] * 2
            assert ds.link._step is None

    def test_attachment_and_meta_survive(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        cntl = ch.call_method("EchoService", "Echo", b"payload", attachment=b"piggyback")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"payload"
        assert cntl.response_attachment == b"piggyback"

    def test_payload_larger_than_slot_spans_steps(self, pkg, echo_server):
        # slot_words=256 -> 1 KiB slots; a 64 KiB frame needs ~64 steps of
        # byte-stream chunking each way
        ch = _tpu_channel(pkg, echo_server, link_slot_words=256, link_window=4)
        big = bytes(range(256)) * 256
        cntl = ch.call_method("EchoService", "Echo", big)
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == big

    def test_many_sequential_calls_share_one_link(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        first = None
        for i in range(20):
            cntl = ch.call_method("EchoService", "Echo", f"msg-{i}".encode())
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == f"msg-{i}".encode()
            if first is None:
                first = ch._device_sock
        assert ch._device_sock is first  # one handshake, one link

    def test_handshake_used_host_socket(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        assert ch.call_method("EchoService", "Echo", b"x").ok()
        # the bootstrap TCP socket exists in the client map independently
        # of the device link
        host = ch._socket_map.get_or_create(_target(ch))
        assert host is not ch._device_sock


class TestContentionAndFlowControl:
    def test_contended_writers(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server, link_slot_words=512, link_window=2)
        errs = []

        def worker(i):
            for j in range(10):
                body = f"t{i}-{j}-".encode() + bytes((i * 31 + j) % 256 for _ in range(3000))
                c = ch.call_method("EchoService", "Echo", body)
                if c.failed() or c.response_payload != body:
                    errs.append((i, j, c.error_code, c.error_text))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs[:3]

    def test_window_bounds_inflight_steps(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server, link_slot_words=256, link_window=2)
        cntl = ch.call_method("EchoService", "Echo", b"w" * 50000)
        assert cntl.ok(), cntl.error_text
        link = ch._device_sock.link
        # the credit window held dispatched-but-undrained steps at <= window
        assert link.inflight_steps <= link.window

    def test_writer_stalls_then_resumes_on_backlog(self, pkg, echo_server):
        # a tiny window and slot make the byte budget small; a burst of
        # sends must block (not error) and every byte must still arrive
        ch = _tpu_channel(pkg, echo_server, link_slot_words=64, link_window=1)
        assert ch.call_method("EchoService", "Echo", b"warm").ok()
        link = ch._device_sock.link
        assert link.send(0, b"AB" * 4000) == 0  # blocks internally while draining
        # the server's messenger refuses the bytes as garbage eventually,
        # but the transport delivered every byte in order first
        assert _wait(lambda: link._closed or link._out_nbytes[0] == 0)


class TestTeardown:
    def test_server_stop_fails_client_link(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        assert ch.call_method("EchoService", "Echo", b"x").ok()
        ds = ch._device_sock
        echo_server.stop()
        assert _wait(lambda: ds.state != 0)  # CONNECTED == 0
        # subsequent calls fail fast or re-handshake-fail, never hang
        c = ch.call_method("EchoService", "Echo", b"y")
        assert c.failed()

    def test_link_failure_reports_not_hangs(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        assert ch.call_method("EchoService", "Echo", b"x").ok()
        ch._device_sock.link.fail("injected")
        c = ch.call_method("EchoService", "Echo", b"y")
        # the failed link is re-handshaken (fresh link), or the call fails
        # visibly — either way no hang
        assert c.ok() or c.error_code != 0

    def test_reconnect_after_link_failure(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        assert ch.call_method("EchoService", "Echo", b"x").ok()
        old = ch._device_sock
        old.link.fail("injected")
        assert _wait(lambda: old.state != 0)
        c = ch.call_method("EchoService", "Echo", b"again")
        assert c.ok(), c.error_text
        assert ch._device_sock is not old  # fresh handshake, fresh link


class _CountingSink:
    """Messenger stand-in that drains the socket read buffer and counts."""

    def __init__(self):
        self.nbytes = 0
        self.chunks = []

    def process(self, sock):
        n = len(sock._read_buf)
        if n:
            self.chunks.append(sock._read_buf.to_bytes(n))
            sock._read_buf.popn(n)
            self.nbytes += n


def _sinked_link(pkg, devices, **kw):
    link = pkg.dl.DeviceLink(devices, **kw)
    sinks = (_CountingSink(), _CountingSink())
    socks = (
        pkg.dl.DeviceSocket(link, side=0, messenger=sinks[0]),
        pkg.dl.DeviceSocket(link, side=1, messenger=sinks[1]),
    )
    return link, socks, sinks


class TestHostLoopbackFastPath:
    """Shared-device geometry: the exchange is a host swap — no device
    step, no readback."""

    def _make_link(self, pkg, **kw):
        dev = pkg.shared_device()
        return _sinked_link(pkg, [dev, dev], **kw)

    def test_same_device_defaults_to_host_swap(self, pkg):
        link, socks, sinks = self._make_link(pkg, slot_words=1024)
        assert link._step is None  # no device step at all
        payload = bytes(range(256)) * 16
        assert link.send(0, payload) == 0
        assert _wait(lambda: sinks[1].nbytes == len(payload))
        assert b"".join(sinks[1].chunks) == payload
        # and the reverse direction
        assert link.send(1, b"pong" * 100) == 0
        assert _wait(lambda: sinks[0].nbytes == 400)

    def test_forced_device_loop_still_works(self, pkg):
        link, socks, sinks = self._make_link(pkg, slot_words=1024, host_loopback=False)
        assert link._step is not None  # the on-device swap
        payload = b"device-loop" * 50
        assert link.send(0, payload) == 0
        assert _wait(lambda: sinks[1].nbytes == len(payload), timeout=30)
        assert b"".join(sinks[1].chunks) == payload

    def test_fast_and_device_paths_deliver_identical_streams(self, pkg):
        payload = bytes((i * 7 + 3) % 256 for i in range(50000))
        outs = []
        for forced in (None, False):
            link, socks, sinks = self._make_link(
                pkg, slot_words=256, window=2, host_loopback=forced
            )
            assert link.send(0, payload) == 0
            assert _wait(lambda: sinks[1].nbytes == len(payload), timeout=60)
            outs.append(b"".join(sinks[1].chunks))
        assert outs[0] == outs[1] == payload

    def test_loopback_throughput_sane(self, pkg):
        # the fast path must move bytes at memcpy-class rates — a
        # regression to per-step device round trips would fail this easily
        link, socks, sinks = self._make_link(pkg, slot_words=256 * 1024, window=8)
        chunk = b"t" * (1 << 20)
        total = 64 << 20
        t0 = time.perf_counter()
        for _ in range(total // len(chunk)):
            assert link.send(0, chunk, timeout=30) == 0
        assert _wait(lambda: sinks[1].nbytes == total, timeout=60)
        gbps = total / (time.perf_counter() - t0) / 1e9
        assert gbps > 0.2, f"loopback link moved only {gbps:.3f} GB/s"


class TestWireAckWindow:
    """ack_mode='wire': the credit window gates on the cumulative-delivered
    count carried in received slot headers (words 3 and 5)."""

    def _make_link(self, pkg, **kw):
        link, _socks, sinks = _sinked_link(pkg, pkg.link_pair(), ack_mode="wire", **kw)
        return link, sinks

    def test_stream_drains_under_wire_acks(self, pkg):
        link, sinks = self._make_link(pkg, slot_words=256, window=4)
        payload = bytes((i * 13 + 5) % 256 for i in range(100_000))
        assert link.send(0, payload, timeout=60) == 0
        assert _wait(lambda: sinks[1].nbytes == len(payload), timeout=60)
        assert b"".join(sinks[1].chunks) == payload
        # the window held: seq never ran more than window + 1 catch-up
        # step ahead of the acks the wire carried
        assert link._seq - link._peer_ack <= link.window + 1

    def test_window_one_still_makes_progress(self, pkg):
        # the degenerate window: every data step needs an ack catch-up
        # step — throughput halves, progress must NOT stop
        link, sinks = self._make_link(pkg, slot_words=128, window=1)
        payload = b"w1" * 3000
        assert link.send(0, payload, timeout=60) == 0
        assert _wait(lambda: sinks[1].nbytes == len(payload), timeout=60)
        assert b"".join(sinks[1].chunks) == payload

    def test_bidirectional_wire_acks(self, pkg):
        link, sinks = self._make_link(pkg, slot_words=256, window=2)
        a = bytes(range(256)) * 40
        b = bytes(reversed(range(256))) * 40
        assert link.send(0, a, timeout=60) == 0
        assert link.send(1, b, timeout=60) == 0
        assert _wait(lambda: sinks[1].nbytes == len(a), timeout=60)
        assert _wait(lambda: sinks[0].nbytes == len(b), timeout=60)
        assert b"".join(sinks[1].chunks) == a
        assert b"".join(sinks[0].chunks) == b

    def test_rpc_over_wire_ack_link(self, pkg, echo_server):
        ch = _tpu_channel(
            pkg, echo_server, link_ack_mode="wire", link_slot_words=256, link_window=2
        )
        big = bytes(range(256)) * 64
        cntl = ch.call_method(
            "EchoService", "Echo", big, cntl=pkg.rpc.Controller(timeout_ms=60000)
        )
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == big
        assert ch._device_sock.link.ack_mode == "wire"


@pytest.mark.parametrize("ack_mode", ["local", "wire"])
@pytest.mark.parametrize("window", [1, 3])
def test_forced_device_form_streams_in_both_ack_modes(ack_mode, window):
    """The port's forced device form on the CPU: both directions' streams
    arrive whole and in order, every step went through the device step, and
    its rows are fresh host tensors."""
    pkg = PKGS["torch"]
    dev = torch.device("cpu")
    link, _socks, sinks = _sinked_link(
        pkg, [dev, dev], slot_words=128, window=window, host_loopback=False, ack_mode=ack_mode
    )
    stepped = []
    orig = link._step

    def spy(slots):
        out, event = orig(slots)
        stepped.append(out)
        return out, event

    link._step = spy
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    assert link.send(0, a, timeout=60) == 0
    assert link.send(1, b, timeout=60) == 0
    assert _wait(lambda: sinks[1].nbytes == len(a) and sinks[0].nbytes == len(b), timeout=60)
    assert b"".join(sinks[1].chunks) == a
    assert b"".join(sinks[0].chunks) == b
    assert len(stepped) == link._seq >= len(a) // 512
    assert len({t.data_ptr() for t in stepped[-2:]}) == len(stepped[-2:])


class TestLinkMap:
    def test_link_map_dedupes_links_across_channels(self, pkg):
        srv = make_server(
            pkg, {"EchoService": {"Echo": lambda cntl, req: req}}, device_index=pkg.peer_index
        )
        ch1 = _tpu_channel(pkg, srv)
        ch2 = _tpu_channel(pkg, srv)
        assert ch1.call_method("EchoService", "Echo", b"a").ok()
        assert ch2.call_method("EchoService", "Echo", b"b").ok()
        # one handshake, one link: both channels share the map entry
        assert ch1._device_sock is ch2._device_sock

    def test_link_map_isolates_credentials(self, pkg, echo_server):
        class FakeAuth:
            def generate_credential(self) -> str:
                return "cred"  # credentials are str by contract

            def verify_credential(self, cred, sock) -> bool:
                return True

        target = _target(_tpu_channel(pkg, echo_server))  # the package's EndPoint
        plain = pkg.dl.device_link_map.get_or_create(target, timeout_ms=30000)
        authed = pkg.dl.device_link_map.get_or_create(target, timeout_ms=30000, auth=FakeAuth())
        # different credentials must NEVER share a link (socket_map.h:35
        # keys by auth identity for the same reason)
        assert plain is not authed
        assert plain.link is not authed.link

    def test_authenticated_link_handshake_presents_credentials(self, pkg):
        srv = make_server(pkg, {"EchoService": {"Echo": lambda cntl, req: req}},
                          auth=pkg.rpc.TokenAuthenticator(["link-token"]))
        ch = _tpu_channel(pkg, srv, auth=pkg.rpc.TokenAuthenticator("link-token"))
        for i in range(3):
            c = ch.call_method("EchoService", "Echo", b"over the link %d" % i)
            assert c.ok(), c.error_text
            assert c.response_payload == b"over the link %d" % i
        assert ch._device_sock is not None and ch._device_sock.link is not None
        bare = _tpu_channel(pkg, srv, max_retry=0)
        c = bare.call_method("EchoService", "Echo", b"no credential")
        assert c.failed()
        # the bootstrap handshake is refused, so the link never forms
        assert c.error_code == ErrorCode.EFAILEDSOCKET
        assert "Unauthorized" in c.error_text

    def test_link_profile_of_a_live_link(self, pkg, echo_server):
        ch = _tpu_channel(pkg, echo_server)
        for _ in range(3):
            assert ch.call_method("EchoService", "Echo", b"p" * 100).ok()
        prof = pkg.dl.link_profile()
        link = ch._device_sock.link
        mine = [p for p in prof.values() if p["link_id"] == link.link_id]
        assert len(mine) == 1
        assert set(mine[0]) == {
            "link_id", "devices", "rtt_us", "rtt_p99_us", "steps", "out_bytes_s",
            "in_bytes_s", "out_bytes", "in_bytes", "gbps",
        }
        assert mine[0]["steps"] >= 6 and mine[0]["out_bytes"] >= 600


class TestStepFailureInjection:
    def test_dispatch_failure_mid_traffic_fails_link_cleanly(self, pkg, echo_server, monkeypatch):
        # inject a step that blows up on the Nth dispatch: the link must
        # fail (not wedge), in-flight callers must get errors, and the
        # next call must re-handshake onto a FRESH link
        if pkg.name == "torch":
            # the port's one CPU device takes the host swap: have the
            # handshake build the forced device form instead
            class ForcedDeviceLink(port_dl.DeviceLink):
                def __init__(self, *args, **kw):
                    super().__init__(*args, host_loopback=False, **kw)

            monkeypatch.setattr(port_dl, "DeviceLink", ForcedDeviceLink)
        Controller = pkg.rpc.Controller
        ch = _tpu_channel(pkg, echo_server)
        assert ch.call_method(
            "EchoService", "Echo", b"warm", cntl=Controller(timeout_ms=30000)
        ).ok()
        link = ch._device_sock.link
        orig_step = link._step
        assert orig_step is not None
        calls = {"n": 0}

        def failing_step(slots):
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("injected device fault")
            return orig_step(slots)

        link._step = failing_step
        c = ch.call_method("EchoService", "Echo", b"boom", cntl=Controller(timeout_ms=10000))
        # either the failure landed mid-call (error) or after (link dead)
        assert c.failed() or link._closed
        assert _wait(lambda: link._closed, timeout=10)
        # recovery: the map re-handshakes a fresh link and traffic resumes
        c2 = ch.call_method("EchoService", "Echo", b"again", cntl=Controller(timeout_ms=30000))
        assert c2.ok(), c2.error_text
        assert ch._device_sock.link is not link


class TestZeroCopyDelivery:
    def test_received_blocks_reference_step_output_memory(self, pkg, echo_server, monkeypatch):
        # the receive path wraps the step output's buffer as an external
        # IOBuf block — no host-side payload copy before the parse boundary.
        # Asserted by address identity: the fed block's view must point
        # INTO the delivered row's own buffer.
        ch = _tpu_channel(pkg, echo_server, link_slot_words=4096)
        assert ch.call_method("EchoService", "Echo", b"warm").ok()
        ext_addrs = []  # addresses handed to append_external
        row_spans = []  # [start, end) of delivered rows' buffers
        orig_ext = pkg.IOBuf.append_external

        def ext_spy(iobuf_self, obj, release_cb=None):
            a = np.frombuffer(memoryview(obj), dtype=np.uint8)
            ext_addrs.append((a.ctypes.data, a.nbytes))
            return orig_ext(iobuf_self, obj, release_cb)

        orig_rows = pkg.dl.DeviceLink._rows_to_host

        def rows_spy(link_self, arrays):
            rows = orig_rows(link_self, arrays)
            for row in rows:
                if row is not None:
                    b = row.view(np.uint8)
                    row_spans.append((b.ctypes.data, b.ctypes.data + b.nbytes))
            return rows

        monkeypatch.setattr(pkg.IOBuf, "append_external", ext_spy)
        monkeypatch.setattr(pkg.dl.DeviceLink, "_rows_to_host", rows_spy)
        big = b"q" * 12000  # > 4096: external-block delivery path
        cntl = ch.call_method("EchoService", "Echo", big)
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == big
        aliased = [
            (a, n) for a, n in ext_addrs for lo, hi in row_spans if lo <= a and a + n <= hi
        ]
        assert aliased, f"no external block aliased a delivered row: {ext_addrs[:3]} vs {row_spans[:3]}"

    def test_iobuf_write_queues_block_views(self, pkg, echo_server):
        # DeviceSocket.write(IOBuf) must not flatten to bytes: the link
        # gathers from the IOBuf's own block views
        ch = _tpu_channel(pkg, echo_server)
        assert ch.call_method("EchoService", "Echo", b"warm").ok()
        link = ch._device_sock.link
        buf = pkg.IOBuf()
        buf.append_external(b"Z" * 9000)
        assert link.send(0, buf) == 0
        assert _wait(lambda: link._out_nbytes[0] == 0)


# -- device RPC over the link ----------------------------------------------------


def _device_link_server(name, mixed):
    """A Server of package ``name`` (handlers not inline) with service
    "tensor" (the echo table's endpoint) and, when ``mixed``, "mixed" with
    methods echo, x2, plus10 and unknown (ids 0, 3, 5, 999)."""
    if name == "torch":
        svc = TensorEchoService()
        svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
        svc.add_method(5, lambda p: kernels.bits32(kernels.u64(p) + 10))
        make = lambda service=None: DeviceEndpoint(  # noqa: E731
            service=service, device="cpu", window_size=16, max_batch=16)
    else:
        svc = JaxService()
        svc.add_method(3, lambda p: p * jnp.uint32(2))
        svc.add_method(5, lambda p: p + jnp.uint32(10))
        make = lambda service=None: JaxEndpoint(  # noqa: E731
            service=service, window_size=16, max_batch=16)
    ep = make()
    _OPEN.append(ep)
    services = {"tensor": {"echo": ep.server_handler()}}
    if mixed:
        mep = make(svc)
        _OPEN.append(mep)
        services["mixed"] = {m: mep.server_handler(method_id=i) for m, i in (
            ("echo", 0), ("x2", 3), ("plus10", 5), ("unknown", 999))}
    return make_server(PKGS[name], services)


def test_device_rpc_over_the_link_answers_as_the_jax_packages():
    out = {}
    for name in ("jax", "torch"):
        srv = _device_link_server(name, mixed=True)
        ch = _tpu_channel(PKGS[name], srv, timeout_ms=60_000)
        rng = np.random.default_rng(5)
        calls = []
        for n in (1, 4, 255, 1000, 32 * 1024, 70_000):
            p = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for service, method in (("tensor", "echo"), ("mixed", "echo"), ("mixed", "x2"),
                                    ("mixed", "plus10"), ("mixed", "unknown")):
                c = ch.call_method(service, method, p)
                calls.append((service, method, n, int(c.error_code), c.response_payload))
        assert ch._device_sock is not None
        out[name] = calls
    assert len(out["torch"]) == len(out["jax"]) == 30
    for w, g in zip(out["jax"], out["torch"]):
        assert g == w, w[:4]
    assert [c[3] for c in out["torch"] if c[1] == "unknown"] == [1002] * 6
    assert all(c[3] == 0 and len(c[4]) == c[2] for c in out["torch"] if c[1] != "unknown")


def test_device_rpc_over_the_link_16_callers_with_fiber_concurrency_4():
    """16 threads x 8 calls over one link into one endpoint (window 16)
    all succeed with a pool of 4 workers: a handler parked on the endpoint
    inside a link delivery does not hold the pool's places."""
    port_rpc.shutdown_host_plane()  # the next pool reads the flag
    port_flags.set_flag_unchecked("fiber_concurrency", 4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        srv = _device_link_server("torch", mixed=False)
        assert global_worker_pool().concurrency == 4
        ch = _tpu_channel(PKGS["torch"], srv, timeout_ms=120_000)
        errors = []

        def caller(i):
            for j in range(8):
                p = bytes([i, j]) * 128  # 256 B
                c = ch.call_method("tensor", "echo", p)
                if not c.ok() or c.response_payload != p:
                    errors.append((i, j, c.error_code))

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert errors == []
        # the server records a call just after writing its response
        assert _wait(lambda: srv.method_status("tensor", "echo").latency.count() == 128)
        assert ch._device_sock is not None and ch._device_sock.link._step is None
    finally:
        sys.setswitchinterval(switch)
        port_flags.set_flag_unchecked("fiber_concurrency", 8)


# -- parity: slot rows, device_method, the scheduler ----------------------------


def _slot_rows(pkg, ack_mode):
    """The seeded send sequence through ``pkg``'s DeviceLink in the host
    swap; returns every slot row as header words + payload bytes."""
    rng = np.random.default_rng(1234)
    dev = pkg.shared_device()
    link, socks, sinks = _sinked_link(pkg, [dev, dev], slot_words=128, window=2, ack_mode=ack_mode)
    assert link._step is None
    rows = []
    orig = link._fill_slot_locked

    def spy(side):
        row = orig(side)
        used = int(row[1])
        rows.append(row[:8].tobytes() + row.view(np.uint8)[32 : 32 + used].tobytes())
        return row

    link._fill_slot_locked = spy

    def drained():
        return (link._out_nbytes == [0, 0] and link.inflight_steps == 0
                and not link._driving)

    sent = [b"", b""]
    for side, n in ((0, 3000), (1, 700), (0, 1), (1, 1537)):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        sent[side] += data
        assert link.send(side, data, timeout=30) == 0
        assert _wait(drained, timeout=30)
    buf = pkg.IOBuf()
    head = rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
    tail = rng.integers(0, 256, 1100, dtype=np.uint8).tobytes()
    buf.append(head)
    buf.append_external(tail)
    sent[0] += head + tail
    assert link.send(0, buf, timeout=30) == 0
    assert _wait(drained, timeout=30)
    link.close(0)
    assert _wait(lambda: socks[0].state != 0 and socks[1].state != 0 and drained(), timeout=30)
    assert b"".join(sinks[1].chunks) == sent[0]
    assert b"".join(sinks[0].chunks) == sent[1]
    return rows


@pytest.mark.parametrize("ack_mode", ["local", "wire"])
def test_slot_rows_byte_identical_to_the_jax_package(ack_mode):
    jax_rows = _slot_rows(PKGS["jax"], ack_mode)
    port_rows = _slot_rows(PKGS["torch"], ack_mode)
    assert len(port_rows) == len(jax_rows) > 20
    assert port_rows == jax_rows


DM_WIDTH = 64


def _xor_jax(data, n):
    return data ^ jnp.uint8(0x5A), n


def _xor_port(data, n, axis):
    return data ^ 0x5A, n


def _resize_jax(data, n):
    # a length-changing kernel: every byte + 1 (mod 256), n -> min(2n + 3, width)
    return data + jnp.uint8(1), jnp.minimum(n * 2 + 3, DM_WIDTH).astype(n.dtype)


def _resize_port(data, n, axis):
    return data + 1, torch.clamp(n * 2 + 3, max=DM_WIDTH).to(n.dtype)


@pytest.mark.parametrize("kernels", [(_xor_jax, _xor_port), (_resize_jax, _resize_port)],
                         ids=["xor", "resize"])
def test_device_method_handler_bitwise_the_jax_package(kernels):
    jax_handler = jax_rpc.device_method(kernels[0], width=DM_WIDTH)
    port_handler = port_rpc.device_method(kernels[1], width=DM_WIDTH)
    assert port_handler._device_method.width == DM_WIDTH
    server = port_rpc.Server(port_rpc.ServerOptions(device="cpu"))
    cntl = types.SimpleNamespace(_server=server)
    rng = np.random.default_rng(5)
    for n in (0, 1, 17, 31, DM_WIDTH):
        req = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = jax_handler(None, req)
        got = port_handler(cntl, req)
        assert got == want, n
    with pytest.raises(ValueError, match="exceeds device-method width"):
        port_handler(cntl, b"x" * (DM_WIDTH + 1))


def test_device_method_over_the_link_answers_as_the_jax_package():
    """A device_method() served by each package's Server and called over
    its own link: identical answers, and the port's server registers and
    advertises the method."""
    answers = {}
    for name, kernel in (("jax", _xor_jax), ("torch", _xor_port)):
        pkg = PKGS[name]
        srv = make_server(pkg, {"dsvc": {"xor": pkg.rpc.device_method(kernel, width=DM_WIDTH)}})
        ch = _tpu_channel(pkg, srv)
        outs = []
        for i in range(4):
            cntl = ch.call_method("dsvc", "xor", bytes(range(i * 10, i * 10 + 9 + i)))
            assert cntl.ok(), cntl.error_text
            outs.append(cntl.response_payload)
        answers[name] = outs
        if name == "torch":
            assert set(srv._device_methods) == {"dsvc.xor"}
            assert set(ch._device_sock.device_methods) == {"dsvc.xor"}
    assert answers["torch"] == answers["jax"]


SCHEDULE_CASES = [
    ([0, 1, 2], {}, 1),
    ([0, 1, 2], None, 4),
    ([0, 1, 2], {1: {"gbps": 2.5, "rtt_us": 10.0}}, 1),
    ([0, 1, 2], {1: {"gbps": 2.5, "rtt_us": 10.0}}, 5),
    ([0, 1, 2], {0: {"gbps": 1.0, "rtt_us": 5.0}, 1: {"gbps": 1.0, "rtt_us": 5.0},
                 2: {"gbps": 1.0, "rtt_us": 9.0}}, 6),
    ([5, 3, 9, 1], {3: {"gbps": 0.0, "rtt_us": 0.0}, 9: {"gbps": 0.5},
                    1: {"rtt_us": 40.0}, 7: {"gbps": 9.0}}, 8),
    ([4], {4: {"gbps": 3.25, "rtt_us": 1.5}}, 3),
]


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=[str(i) for i in range(len(SCHEDULE_CASES))])
def test_schedule_session_order_equals_the_jax_package(case):
    party_ids, profile, chunks = case
    got = port_mcd.schedule_session_order(party_ids, profile, chunks)
    want = jax_mcd.schedule_session_order(party_ids, profile, chunks)
    assert got == want


def test_default_link_profile_reads_the_port_links(echo_server, pkg):
    ch = _tpu_channel(pkg, echo_server)
    assert ch.call_method("EchoService", "Echo", b"x").ok()
    mcd = port_mcd if pkg.name == "torch" else jax_mcd
    prof = mcd._default_link_profile()
    assert any(p["link_id"] == ch._device_sock.link.link_id for p in prof.values())


# -- chip_smoke.py phase 3c's helpers on the CPU --------------------------------


@pytest.mark.parametrize("host_loopback", [None, False], ids=["host_swap", "device"])
@pytest.mark.parametrize("ack_mode", ["local", "wire"])
def test_chip_smoke_link_stream_on_the_cpu(host_loopback, ack_mode):
    import chip_smoke

    chunks = chip_smoke.stream_chunks(size=64 << 10, distinct=3)
    total = 2 << 20
    _, sink, link = chip_smoke.link_stream(
        port_dl, torch.device("cpu"), host_loopback, ack_mode, chunks, total,
        hashed=True, slot_words=4096, window=4,
    )
    assert sink.nbytes == total
    assert sink.crc == chip_smoke.stream_crc(chunks, total)
    assert (link._step is None) == (host_loopback is None)
    assert link._closed  # failed once the stream is done


def test_chip_smoke_device_method_expected_is_the_port_handler():
    import chip_smoke
    from incubator_brpc_tpu_torch.parallel import quantized as Q

    quant = Q.quantized_pmean_dm(chip_smoke.QUANT_WIDTH, chip_smoke.QUANT_MODE, chip_smoke.QUANT_BLOCK)
    handler = port_rpc.device_method(quant.kernel, width=chip_smoke.QUANT_WIDTH, chunkable=True)
    cntl = types.SimpleNamespace(_server=port_rpc.Server(port_rpc.ServerOptions(device="cpu")))
    rng = np.random.default_rng(34)
    for _ in range(3):
        req = (rng.standard_normal(chip_smoke.QUANT_WIDTH // 4) * 10 ** rng.uniform(-3, 3)).astype(
            np.float32).tobytes()
        assert handler(cntl, req) == chip_smoke.link_device_method_expected(req)
