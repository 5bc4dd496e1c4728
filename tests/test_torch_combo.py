"""The port's combo channels (``incubator_brpc_tpu_torch.rpc.combo``:
ParallelChannel, SelectiveChannel, PartitionChannel, DynamicPartitionChannel)
in their host form on the CPU, held against the JAX package's:

- all 24 tests of tests/test_combo.py, ``TestDynamicPartitionChannel`` of
  tests/test_auth_dynpart_memcache.py (3), and ``test_lb_target_with_tpu_transport``
  and ``test_partition_channel_over_device_links`` of tests/test_device_link.py,
  each run on both packages with the answers the JAX package's own tests
  assert. The port's servers use ``ServerOptions(device="cpu")``: its links
  share the one device (the host swap), where the JAX package's, on the
  conftest's 8 virtual devices, keep their distinct-device asserts;
- the fused refusal: a ParallelChannel over four ``transport="tpu"``
  sub-channels (``la`` LB channels) to servers of one device method runs the
  host fan-out while the links share the device; with the sub-links' server
  devices patched apart it raises ``NotImplementedError`` naming ROADMAP A3
  and leaves no ``la`` pick unsettled, and ``fuse_device_calls=False`` answers
  by the host fan-out with the bytes of the JAX package's fused dispatch;
- device RPC fanned out: a ParallelChannel over four servers of
  ``DeviceEndpoint(device="cpu").server_handler()`` (the echo table and
  methods {0, 3, 5}), 8 threads x 4 fan-outs with ``fiber_concurrency`` 4,
  every merged answer the four expected ones in channel order; a
  PartitionChannel over four servers of the quantized pmean device method
  answers four copies of the numpy twin's bytes;
- a PartitionChannel's ``stop()`` detaches every partition LB from the
  shared naming thread and leaves no revival timer armed.

Each test stops the servers and endpoints it started; after each the port's
host plane and timer thread are shut down and no ``tbtorch-*`` thread is
left."""

import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.rpc.combo as jax_combo
import incubator_brpc_tpu.naming as jax_naming
import incubator_brpc_tpu_torch.naming as port_naming
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.rpc.combo as port_combo
from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService
from incubator_brpc_tpu_torch.ops import kernels
from incubator_brpc_tpu_torch.parallel import quantized as Q
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.runtime.worker_pool import global_worker_pool
from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint
from incubator_brpc_tpu_torch.transport.device_link import device_link_map
from incubator_brpc_tpu_torch.utils import flags as port_flags
from incubator_brpc_tpu_torch.utils.status import ErrorCode

PKGS = {
    "jax": types.SimpleNamespace(name="jax", rpc=jax_rpc, combo=jax_combo, naming=jax_naming,
                                 server_kw={}),
    "torch": types.SimpleNamespace(name="torch", rpc=port_rpc, combo=port_combo,
                                   naming=port_naming, server_kw={"device": "cpu"}),
}

_OPEN = []  # servers and endpoints the test started, closed at teardown


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    while _OPEN:
        obj = _OPEN.pop()
        if isinstance(obj, DeviceEndpoint):
            assert obj.close(timeout=60)
        else:
            obj.stop()
            obj.join(timeout=10)
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def start_server(pkg, services, **opts):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**opts, **pkg.server_kw))
    for name, handlers in services.items():
        srv.add_service(name, handlers)
    assert srv.start(0)
    _OPEN.append(srv)
    return srv


def make_server(pkg, name: bytes):
    """Echo server that prefixes responses with its name."""

    def echo(cntl, request):
        return name + b":" + request

    def fail(cntl, request):
        cntl.set_failed(ErrorCode.EINTERNAL, "injected failure")
        return b""

    def slow(cntl, request):
        time.sleep(0.3)
        return name + b":slow"

    return start_server(pkg, {"svc": {"echo": echo, "fail": fail, "slow": slow}})


@pytest.fixture
def three_servers(pkg):
    return [make_server(pkg, b"s%d" % i) for i in range(3)]


def sub_channel(pkg, server):
    ch = pkg.rpc.Channel()
    assert ch.init(f"127.0.0.1:{server.port}")
    return ch


def channel_to(pkg, target):
    ch = pkg.rpc.Channel()
    assert ch.init(target)
    return ch


# -- tests/test_combo.py ---------------------------------------------------------


class TestParallelChannel:
    def test_broadcast_and_merge_in_index_order(self, pkg, three_servers):
        pc = pkg.rpc.ParallelChannel()
        for s in three_servers:
            pc.add_channel(sub_channel(pkg, s))
        cntl = pc.call_method("svc", "echo", b"hi")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"s0:his1:his2:hi"

    def test_call_mapper_rewrites_and_skips(self, pkg, three_servers):
        class Mapper(pkg.rpc.CallMapper):
            def map(self, i, n, service, method, request):
                if i == 1:
                    return pkg.rpc.SubCall.skip()
                return pkg.rpc.SubCall(request=b"%d" % i)

        pc = pkg.rpc.ParallelChannel()
        for s in three_servers:
            pc.add_channel(sub_channel(pkg, s), call_mapper=Mapper())
        cntl = pc.call_method("svc", "echo", b"ignored")
        assert cntl.ok()
        assert cntl.response_payload == b"s0:0s2:2"

    def test_default_fail_limit_tolerates_partial_failure(self, pkg, three_servers):
        class Mapper(pkg.rpc.CallMapper):
            def map(self, i, n, service, method, request):
                return pkg.rpc.SubCall(method="fail" if i == 0 else "echo")

        pc = pkg.rpc.ParallelChannel()
        for s in three_servers:
            pc.add_channel(sub_channel(pkg, s), call_mapper=Mapper())
        cntl = pc.call_method("svc", "echo", b"x")
        assert cntl.ok()
        assert cntl.response_payload == b"s1:xs2:x"

    def test_fail_limit_one_fails_fast(self, pkg, three_servers):
        class Mapper(pkg.rpc.CallMapper):
            def map(self, i, n, service, method, request):
                return pkg.rpc.SubCall(method="fail" if i == 2 else "echo")

        pc = pkg.rpc.ParallelChannel(fail_limit=1)
        for s in three_servers:
            pc.add_channel(sub_channel(pkg, s), call_mapper=Mapper())
        cntl = pc.call_method("svc", "echo", b"x")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.EINTERNAL

    def test_all_failed_fails_parent(self, pkg, three_servers):
        pc = pkg.rpc.ParallelChannel()
        for s in three_servers:
            pc.add_channel(sub_channel(pkg, s))
        cntl = pc.call_method("svc", "fail", b"x")
        assert cntl.failed()

    def test_custom_merger(self, pkg, three_servers):
        class Longest(pkg.rpc.ResponseMerger):
            def merge(self, merged, sub):
                return sub if len(sub) > len(merged) else merged

        pc = pkg.rpc.ParallelChannel()
        for s in three_servers:
            pc.add_channel(sub_channel(pkg, s), response_merger=Longest())
        cntl = pc.call_method("svc", "echo", b"zz")
        assert cntl.ok()
        assert cntl.response_payload == b"s0:zz"

    def test_async_done(self, pkg, three_servers):
        pc = pkg.rpc.ParallelChannel()
        for s in three_servers:
            pc.add_channel(sub_channel(pkg, s))
        ev = threading.Event()
        out = {}

        def done(c):
            out["payload"] = c.response_payload
            ev.set()

        pc.call_method("svc", "echo", b"a", done=done)
        assert ev.wait(timeout=5)
        assert out["payload"] == b"s0:as1:as2:a"


class TestSelectiveChannel:
    def test_round_robins_across_channels(self, pkg, three_servers):
        sc = pkg.rpc.SelectiveChannel()
        for s in three_servers:
            sc.add_channel(sub_channel(pkg, s))
        seen = set()
        for _ in range(6):
            cntl = sc.call_method("svc", "echo", b"q")
            assert cntl.ok()
            seen.add(cntl.response_payload)
        assert seen == {b"s0:q", b"s1:q", b"s2:q"}

    def test_failover_to_other_replica(self, pkg, three_servers):
        sc = pkg.rpc.SelectiveChannel(max_retry=2)
        sc.add_channel(channel_to(pkg, "127.0.0.1:1"))  # connect fails: EFAILEDSOCKET
        sc.add_channel(sub_channel(pkg, three_servers[0]))
        for _ in range(4):
            cntl = sc.call_method("svc", "echo", b"f")
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == b"s0:f"

    def test_application_error_does_not_failover(self, pkg, three_servers):
        sc = pkg.rpc.SelectiveChannel(max_retry=2)
        for s in three_servers:
            sc.add_channel(sub_channel(pkg, s))
        cntl = sc.call_method("svc", "fail", b"x")
        assert cntl.failed()
        assert cntl.error_code == ErrorCode.EINTERNAL

    def test_async_done_does_not_block(self, pkg, three_servers):
        sc = pkg.rpc.SelectiveChannel()
        for s in three_servers:
            sc.add_channel(sub_channel(pkg, s))
        ev = threading.Event()
        out = {}

        def done(c):
            out["p"] = c.response_payload
            ev.set()

        t0 = time.monotonic()
        sc.call_method("svc", "slow", b"x", done=done)
        assert time.monotonic() - t0 < 0.2  # returned before the 0.3 s handler
        assert ev.wait(timeout=5)
        assert out["p"].endswith(b":slow")

    def test_per_call_deadline_covers_all_retries(self, pkg):
        sc = pkg.rpc.SelectiveChannel(max_retry=5)
        for port in (1, 2, 3):
            sc.add_channel(channel_to(pkg, f"127.0.0.1:{port}"))
        cntl = pkg.rpc.Controller(timeout_ms=400, max_retry=5)
        t0 = time.monotonic()
        sc.call_method("svc", "echo", b"x", cntl=cntl)
        assert cntl.failed()
        assert time.monotonic() - t0 < 2.0  # not 6 x timeout

    def test_all_dead_fails(self, pkg):
        sc = pkg.rpc.SelectiveChannel(max_retry=3)
        for port in (1, 2):
            sc.add_channel(channel_to(pkg, f"127.0.0.1:{port}"))
        cntl = sc.call_method("svc", "echo", b"x")
        assert cntl.failed()


class _ScriptedSub:
    """Stand-in sub-channel whose outcomes are driven by the test."""

    def __init__(self):
        self.healthy = True
        self.calls = 0

    def call_method(self, service, method, request, cntl=None, done=None):
        self.calls += 1
        if self.healthy:
            cntl.response_payload = b"ok:" + request
        else:
            cntl.set_failed(ErrorCode.EFAILEDSOCKET, "scripted transport down")
        if done:
            done(cntl)
        return cntl


class TestSelectiveChannelHealth:
    def test_downed_sub_is_excluded_until_revive_probe(self, pkg):
        a, b = _ScriptedSub(), _ScriptedSub()
        b.healthy = False
        sc = pkg.rpc.SelectiveChannel(max_retry=2, lb_name="rr", health_check_fails=2,
                                      health_check_interval_s=0.3)
        sc.add_channel(a)
        sc.add_channel(b)
        for _ in range(10):
            cntl = sc.call_method("s", "m", b"x")
            assert cntl.ok(), cntl.error_text
        health = {h["index"]: h for h in sc.health()}
        assert health[1]["down"], health
        b_calls_when_downed = b.calls
        for _ in range(10):
            assert sc.call_method("s", "m", b"x").ok()
        assert b.calls == b_calls_when_downed, "downed sub still picked"
        time.sleep(0.35)
        for _ in range(6):
            assert sc.call_method("s", "m", b"x").ok()
        assert b.calls == b_calls_when_downed + 1, "revive probe count"
        b.healthy = True
        time.sleep(0.65)  # doubled backoff
        for _ in range(8):
            assert sc.call_method("s", "m", b"x").ok()
        health = {h["index"]: h for h in sc.health()}
        assert not health[1]["down"], health
        assert b.calls > b_calls_when_downed + 1, "recovered sub not reused"

    def test_all_down_still_probes_rather_than_failing(self, pkg):
        a = _ScriptedSub()
        a.healthy = False
        sc = pkg.rpc.SelectiveChannel(max_retry=1, lb_name="rr", health_check_fails=1,
                                      health_check_interval_s=5.0)
        sc.add_channel(a)
        assert sc.call_method("s", "m", b"x").failed()
        calls_before = a.calls
        cntl = sc.call_method("s", "m", b"x")
        assert cntl.failed()
        assert a.calls > calls_before, "no probe attempted when all down"

    def test_real_server_outage_shifts_traffic_off_the_replica(self, pkg):
        alive = make_server(pkg, b"alive")
        dying = make_server(pkg, b"dying")
        sc = pkg.rpc.SelectiveChannel(max_retry=2, lb_name="rr", health_check_fails=2,
                                      health_check_interval_s=30.0)
        for srv in (alive, dying):
            sc.add_channel(sub_channel(pkg, srv))
        for _ in range(4):
            assert sc.call_method("svc", "echo", b"w").ok()
        dying.stop()
        dying.join(timeout=5)
        for _ in range(8):
            cntl = sc.call_method("svc", "echo", b"w")
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == b"alive:w"
        health = {h["index"]: h for h in sc.health()}
        assert health[1]["down"], health


class TestNamingTagDiff:
    def test_tag_change_is_remove_then_add(self, pkg, tmp_path):
        f = tmp_path / "servers"
        f.write_text("127.0.0.1:7001 0/2\n")
        nst = pkg.naming.NamingServiceThread(f"file://{f}")
        nst.stop()  # no timer; _refresh is driven by hand
        events = []

        class Obs:
            def add_server(self, ep):
                events.append(("add", ep.port, ep.tag))

            def remove_server(self, ep):
                events.append(("rm", ep.port, ep.tag))

        nst._refresh()
        nst.add_observer(Obs())
        f.write_text("127.0.0.1:7001 1/2\n")
        nst._refresh()
        assert events == [("add", 7001, "0/2"), ("rm", 7001, "0/2"), ("add", 7001, "1/2")]

    def test_one_address_two_tags_both_tracked(self, pkg, tmp_path):
        f = tmp_path / "servers"
        f.write_text("127.0.0.1:7002 0/2\n127.0.0.1:7002 1/2\n")
        nst = pkg.naming.NamingServiceThread(f"file://{f}")
        nst.stop()
        nst._refresh()
        assert {(ep.port, ep.tag) for ep in nst.servers()} == {(7002, "0/2"), (7002, "1/2")}
        removed = []

        class Obs:
            def add_server(self, ep):
                pass

            def remove_server(self, ep):
                removed.append(ep.tag)

        nst.add_observer(Obs())
        f.write_text("\n")
        nst._refresh()
        assert sorted(removed) == ["0/2", "1/2"]


class TestPartitionChannel:
    def test_parser(self, pkg):
        p = pkg.rpc.PartitionParser()
        assert p.parse("0/3") == (0, 3)
        assert p.parse("2/3") == (2, 3)
        assert p.parse("3/3") is None
        assert p.parse("junk") is None
        assert p.parse("") is None

    def test_fanout_across_partitions(self, pkg, three_servers):
        url = "list://" + ",".join(f"127.0.0.1:{s.port} {i}/3" for i, s in enumerate(three_servers))
        pc = pkg.rpc.PartitionChannel()
        assert pc.init(url, partition_count=3)
        cntl = pc.call_method("svc", "echo", b"p")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"s0:ps1:ps2:p"
        pc.stop()

    def test_untagged_servers_excluded(self, pkg, three_servers):
        url = "list://" + ",".join([
            f"127.0.0.1:{three_servers[0].port} 0/2",
            f"127.0.0.1:{three_servers[1].port} 1/2",
            f"127.0.0.1:{three_servers[2].port} other",
        ])
        pc = pkg.rpc.PartitionChannel()
        assert pc.init(url, partition_count=2)
        cntl = pc.call_method("svc", "echo", b"u")
        assert cntl.ok()
        assert cntl.response_payload == b"s0:us1:u"
        pc.stop()

    def test_empty_partition_fails_sub_call(self, pkg, three_servers):
        url = f"list://127.0.0.1:{three_servers[0].port} 0/2"  # partition 1 is empty
        pc = pkg.rpc.PartitionChannel()
        assert pc.init(url, partition_count=2)
        cntl = pc.call_method("svc", "echo", b"e")
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"s0:e"
        pc.stop()


class TestSelectiveChannelEmbeddedLB:
    def test_la_lb_prefers_the_fast_replica(self, pkg):
        fast = start_server(pkg, {"s": {"m": lambda cntl, req: b"fast"}})

        def slow_m(cntl, req):
            time.sleep(0.05)
            return b"slow"

        slow = start_server(pkg, {"s": {"m": slow_m}})
        sc = pkg.rpc.SelectiveChannel(lb_name="la")
        for srv in (fast, slow):
            sc.add_channel(sub_channel(pkg, srv))
        results = []
        for _ in range(30):
            c = sc.call_method("s", "m", b"")
            assert c.ok(), c.error_text
            results.append(c.response_payload)
        tail = results[10:]
        assert tail.count(b"fast") > tail.count(b"slow"), tail

    def test_failed_replica_excluded_then_recovers_selection(self, pkg):
        alive = start_server(pkg, {"s": {"m": lambda cntl, req: b"ok"}})
        dead = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        dead.add_service("s", {"m": lambda cntl, req: b"dead"})
        assert dead.start(0)
        dead_port = dead.port
        dead.stop()
        dead.join(timeout=5)
        sc = pkg.rpc.SelectiveChannel(max_retry=2, lb_name="rr")
        for target in (f"127.0.0.1:{dead_port}", f"127.0.0.1:{alive.port}"):
            sc.add_channel(channel_to(pkg, target))
        for _ in range(4):
            c = sc.call_method("s", "m", b"")
            assert c.ok(), c.error_text
            assert c.response_payload == b"ok"


# -- tests/test_auth_dynpart_memcache.py: TestDynamicPartitionChannel -----------


class TestDynamicPartitionChannel:
    def test_mixed_schemes_both_serve(self, pkg):
        servers = [make_server(pkg, b"s%d" % i) for i in range(3)]
        url = "list://" + ",".join([
            f"127.0.0.1:{servers[0].port} 0/1",
            f"127.0.0.1:{servers[1].port} 0/2",
            f"127.0.0.1:{servers[2].port} 1/2",
        ])
        dpc = pkg.rpc.DynamicPartitionChannel()
        assert dpc.init(url)
        got = set()
        for _ in range(40):
            cntl = dpc.call_method("svc", "echo", b"q")
            assert cntl.ok(), cntl.error_text
            got.add(cntl.response_payload)
        assert b"s0:q" in got  # scheme /1
        assert b"s1:qs2:q" in got  # scheme /2 fan-out, merged in order
        dpc.stop()

    def test_single_scheme_behaves_like_partition_channel(self, pkg):
        servers = [make_server(pkg, b"p%d" % i) for i in range(2)]
        url = "list://" + ",".join(f"127.0.0.1:{s.port} {i}/2" for i, s in enumerate(servers))
        dpc = pkg.rpc.DynamicPartitionChannel()
        assert dpc.init(url)
        cntl = dpc.call_method("svc", "echo", b"z")
        assert cntl.ok()
        assert cntl.response_payload == b"p0:zp1:z"
        dpc.stop()

    def test_no_tagged_servers_fails(self, pkg):
        dpc = pkg.rpc.DynamicPartitionChannel()
        assert dpc.init("list://127.0.0.1:1 junktag")
        cntl = dpc.call_method("svc", "echo", b"x")
        assert cntl.failed()
        dpc.stop()


# -- tests/test_device_link.py: the combo and LB cases over device links --------


def _server_devices(pkg, links):
    return [str(link.devices[1]) for link in links]


def test_lb_target_with_tpu_transport(pkg):
    servers = []
    for i in range(2):
        kw = {"device_index": i + 1} if pkg.name == "jax" else {}
        servers.append(start_server(pkg, {"svc": {"who": (lambda cntl, req, _i=i: f"s{_i}".encode())}},
                                    **kw))
    ch = pkg.rpc.Channel()
    assert ch.init(f"list://127.0.0.1:{servers[0].port},127.0.0.1:{servers[1].port}", "rr",
                   options=pkg.rpc.ChannelOptions(transport="tpu", timeout_ms=60000))
    seen = set()
    for _ in range(6):
        cntl = ch.call_method("svc", "who", b"")
        assert cntl.ok(), cntl.error_text
        seen.add(cntl.response_payload)
    assert seen == {b"s0", b"s1"}  # rr rotated across both peers
    if pkg.name == "torch":
        # host sockets and device links share one id registry: the LB's
        # map holds both kinds, apart, each under its peer's endpoint
        by_sid = dict(ch._lb._ep_by_sid)
        links = [ds for ds in device_link_map.live_links()]
        hosts = [port_rpc.client_socket_map().get_or_create(e) for e in set(by_sid.values())]
        assert sorted(by_sid) == sorted(s.id for s in links + hosts)  # 4 ids, none shared
        assert {e.port for e in by_sid.values()} == {s.port for s in servers}
        assert ch._device_sock.link.devices == [torch.device("cpu")] * 2
    ch._lb.stop()


def test_partition_channel_over_device_links(pkg):
    if pkg.name == "jax" and len(jax.devices()) < 5:
        pytest.skip("needs a 5+ device mesh")
    servers = []
    for i in range(4):
        kw = {"device_index": i + 1} if pkg.name == "jax" else {}
        servers.append(start_server(
            pkg, {"part": {"get": (lambda cntl, req, _i=i: f"p{_i}:".encode() + req)}},
            usercode_inline=True, **kw))
    url = "list://" + ",".join(f"127.0.0.1:{s.port} {i}/4" for i, s in enumerate(servers))
    pc = pkg.rpc.PartitionChannel()
    assert pc.init(url, partition_count=4,
                   options=pkg.rpc.ChannelOptions(transport="tpu", timeout_ms=60000))
    cntl = pc.call_method("part", "get", b"X", cntl=pkg.rpc.Controller(timeout_ms=60000))
    assert cntl.ok(), cntl.error_text
    assert cntl.response_payload == b"p0:Xp1:Xp2:Xp3:X"
    links = [sub[0]._device_sock.link for sub in pc._subs]
    client_devs = {str(link.devices[0]) for link in links}
    server_devs = _server_devices(pkg, links)
    assert len(client_devs) == 1
    if pkg.name == "jax":
        # every sub-channel rides a link to a DIFFERENT server device, all
        # sharing the client device — a 5-party star
        assert all(link._mesh is not None for link in links)
        assert len(set(server_devs)) == 4
        assert client_devs.isdisjoint(server_devs)
    else:
        # one device: four links, each taking the host swap on it
        assert len(set(map(id, links))) == 4
        assert server_devs == ["cpu"] * 4 and client_devs == {"cpu"}
        assert all(link._step is None for link in links)
    pc.stop()
    if pkg.name == "torch":
        assert pc._ns_thread._observers == []
        assert all(not lb._revive_timers for lb in pc._lbs)


# -- port-only: the fused refusal, device RPC fanned out ------------------------

XFORM_WIDTH = 512


def _xform_jax(data, n):
    # add the byte's index, wrap mod 256 (a wrong shard order shows in the bytes)
    return data + jnp.arange(data.shape[0], dtype=jnp.uint8), n


def _xform_port(data, n, axis):
    return data + torch.arange(data.shape[-1], dtype=torch.uint8, device=data.device), n


class _PerIndexMapper:
    def map(self, i, nchan, service, method, request):
        return PKGS["torch"].rpc.SubCall(request=bytes([i * 10]) * (i + 3))


class _JaxPerIndexMapper:
    def map(self, i, nchan, service, method, request):
        return jax_rpc.SubCall(request=bytes([i * 10]) * (i + 3))


def _jax_fused_answer():
    servers = [start_server(PKGS["jax"], {"dsvc": {"xform": jax_rpc.device_method(
        _xform_jax, width=XFORM_WIDTH)}}, device_index=i + 1, usercode_inline=True)
        for i in range(4)]
    pc = jax_rpc.ParallelChannel(fuse_device_calls=True)
    for s in servers:
        ch = jax_rpc.Channel()
        assert ch.init(f"127.0.0.1:{s.port}",
                       options=jax_rpc.ChannelOptions(transport="tpu", timeout_ms=60000))
        pc.add_channel(ch, call_mapper=_JaxPerIndexMapper())
    cntl = pc.call_method("dsvc", "xform", b"ignored", cntl=jax_rpc.Controller(timeout_ms=60000))
    assert cntl.ok(), cntl.error_text
    assert getattr(cntl, "collective_fused", False) is True
    return cntl.response_payload


def test_fusable_fanout_raises_naming_a3_and_host_fanout_answers():
    if len(jax.devices()) < 5:
        pytest.skip("needs a 5+ device mesh for the JAX package's fused dispatch")
    want = _jax_fused_answer()
    servers = [start_server(PKGS["torch"], {"dsvc": {"xform": port_rpc.device_method(
        _xform_port, width=XFORM_WIDTH)}}) for _ in range(4)]
    subs = []
    for s in servers:
        ch = port_rpc.Channel()
        assert ch.init(f"list://127.0.0.1:{s.port}", "la",
                       options=port_rpc.ChannelOptions(transport="tpu", timeout_ms=60000))
        subs.append(ch)

    def parallel(fuse):
        pc = port_rpc.ParallelChannel(fuse_device_calls=fuse)
        for ch in subs:
            pc.add_channel(ch, call_mapper=_PerIndexMapper())
        return pc

    def inflight():
        return [st.inflight for ch in subs for st in ch._lb.lb._stats.values()]

    fanouts = port_combo.host_fanouts.get_value()
    cntl = parallel(True).call_method("dsvc", "xform", b"ignored",
                                      cntl=port_rpc.Controller(timeout_ms=60000))
    assert cntl.ok(), cntl.error_text
    assert cntl.response_payload == want  # shared device: the host fan-out
    assert port_combo.host_fanouts.get_value() == fanouts + 1
    assert not getattr(cntl, "collective_fused", False)
    assert inflight() == [0] * 4
    links = [ch._device_sock.link for ch in subs]
    saved = [list(link.devices) for link in links]
    try:
        for i, link in enumerate(links):  # four distinct server devices
            link.devices = [torch.device("cpu"), torch.device("cuda", i)]
        with pytest.raises(NotImplementedError, match=r"ROADMAP A3\b"):
            parallel(True).call_method("dsvc", "xform", b"ignored",
                                       cntl=port_rpc.Controller(timeout_ms=60000))
        assert inflight() == [0] * 4  # every probe's la pick was settled
        assert port_combo.host_fanouts.get_value() == fanouts + 1
        cntl = parallel(False).call_method("dsvc", "xform", b"ignored",
                                           cntl=port_rpc.Controller(timeout_ms=60000))
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == want
        assert len(want) == 3 + 4 + 5 + 6
    finally:
        for link, devices in zip(links, saved):
            link.devices = devices
    for ch in subs:
        ch._lb.stop()


def _echo_table_server():
    svc = TensorEchoService()
    svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
    svc.add_method(5, lambda p: kernels.bits32(kernels.u64(p) + 10))
    ep = DeviceEndpoint(service=svc, device="cpu", window_size=16, max_batch=16)
    _OPEN.append(ep)
    return start_server(PKGS["torch"], {"tensor": {
        name: ep.server_handler(method_id=mid) for mid, name in ((0, "echo"), (3, "x2"),
                                                                (5, "plus10"))}})


def test_parallel_channel_over_device_links_8_callers_with_fiber_concurrency_4():
    """Four sub-calls a fan-out, each parked on a link delivery and on the
    endpoint: 8 threads x 4 fan-outs all answer with a pool of 4 workers."""
    port_rpc.shutdown_host_plane()  # the next pool reads the flag
    port_flags.set_flag_unchecked("fiber_concurrency", 4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        servers = [_echo_table_server() for _ in range(4)]
        assert global_worker_pool().concurrency == 4
        pc = port_rpc.ParallelChannel()
        for s in servers:
            ch = port_rpc.Channel()
            assert ch.init(f"127.0.0.1:{s.port}",
                           options=port_rpc.ChannelOptions(transport="tpu", timeout_ms=120_000))
            pc.add_channel(ch)
        errors = []
        methods = {0: "echo", 3: "x2", 5: "plus10"}

        def caller(i):
            for j in range(4):
                mid = (0, 3, 5)[(i + j) % 3]
                p = bytes([i, j, 7, 9]) * 64  # 256 B
                c = pc.call_method("tensor", methods[mid], p,
                                   cntl=port_rpc.Controller(timeout_ms=120_000))
                words = np.frombuffer(p, np.uint32)
                if not c.ok() or c.response_payload != chip_smoke.expected(words, mid).tobytes() * 4:
                    errors.append((i, j, c.error_code, c.error_text))

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert errors == []
        assert all(sub[0]._device_sock.link._step is None for sub in pc._subs)
    finally:
        sys.setswitchinterval(switch)
        port_flags.set_flag_unchecked("fiber_concurrency", 8)


def test_partition_channel_over_quantized_pmean_servers():
    """Four partitions each serving the quantized pmean device method over
    links: the merged answer is four copies of the numpy twin's bytes."""
    quant = Q.quantized_pmean_dm(chip_smoke.QUANT_WIDTH, chip_smoke.QUANT_MODE,
                                 chip_smoke.QUANT_BLOCK)
    servers = [start_server(PKGS["torch"], {"quant": {"pmean": port_rpc.device_method(
        quant.kernel, width=chip_smoke.QUANT_WIDTH, chunkable=True)}}) for _ in range(4)]
    url = "list://" + ",".join(f"127.0.0.1:{s.port} {i}/4" for i, s in enumerate(servers))
    pc = port_rpc.PartitionChannel()
    assert pc.init(url, partition_count=4,
                   options=port_rpc.ChannelOptions(transport="tpu", timeout_ms=60000))
    rng = np.random.default_rng(36)
    for _ in range(2):
        req = rng.standard_normal(chip_smoke.QUANT_WIDTH // 4).astype(np.float32).tobytes()
        cntl = pc.call_method("quant", "pmean", req, cntl=port_rpc.Controller(timeout_ms=60000))
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == chip_smoke.link_device_method_expected(req) * 4
    pc.stop()
