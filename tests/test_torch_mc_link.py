"""The port's multi-controller device link (``incubator_brpc_tpu_torch.
transport.mc_link``) across processes on the CPU, under the assertions of
tests/test_mc_link.py with devices read as ranks:

- the port's harness (``transport/mc_worker.py``) with ``--device cpu
  --backend gloo``: ``test_two_process_echo``,
  ``test_two_process_windowed_burst`` (20000 B through 128-word slots,
  window 2, more than 160 steps), ``test_three_process_fabric`` (a
  PartitionChannel over two links from one client rank to two server
  ranks) and ``test_peer_death_fails_link_fast`` (the server process
  ``os._exit``s inside a handler; the in-flight RPC fails with
  EFAILEDSOCKET in seconds, neither the 30 s deadline nor the wedge
  timer). Each server reports the link halves it held: both halves of a
  link dispatched the same steps and agree on one ``final_target``;
- the pair against the JAX harness's run of the same arguments
  (``incubator_brpc_tpu.transport.mc_worker.orchestrate_pair``): the same
  echoes byte for byte (each client checks every echo; the port's CRC-32
  of them is the expected one), ``steps >= n_rpcs`` and ``peer_ack > 0``
  in both, a final target in both;
- in-process unit tests of the control plane, two link halves driven in
  threads over two ``ProcessGroupGloo``s on one ``HashStore``, the control
  messages carried in order by a queue per side: the want/target join
  (each side's target the max of both wants), and the close dance under
  the orders ``close_req`` may take (one side closes, both close at once,
  one closes while the other still has bytes queued): ``final`` is the
  same on both sides, both dispatch exactly ``final`` steps, every byte
  queued before the close arrives;
- the handshake's refusals: no job, the same rank on both sides, a
  backend the server's job does not run;
- the harness's session options, which raised naming A4b until the
  collective session plane landed, run (``--collective-steps`` and
  ``--mc-lowering-check`` on the fabric, ``--chaos-kill-at-step`` in the
  chaos drill; tests/test_torch_mc_session.py holds the sessions
  themselves);
- chip_smoke.py's phase 3e rehearsed on the CPU (``mc_phase(device="cpu")``:
  the streams, the pair with device RPC, the burst, the probe, the fabric
  and peer death, each checked as on the card but for K1's launches).

tests/test_mc_link.py's ``test_three_process_collective_session`` is
``test_session_options_wait_for_a4b[option0]`` here.
"""

import json
import queue
import threading
import time
import zlib

import pytest
import torch.distributed as dist

import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport import mc_worker
from incubator_brpc_tpu_torch.transport.device_link import DeviceSocket
from incubator_brpc_tpu_torch.transport.mc_link import MultiControllerLink
from incubator_brpc_tpu_torch.utils import distributed as port_dist
from incubator_brpc_tpu_torch.utils.status import ErrorCode

CPU = dict(device="cpu", backend="gloo")


@pytest.fixture(scope="module")
def fabric_pair():
    """One two-process run of the port's pair, shared by the module."""
    return mc_worker.orchestrate_pair(**CPU)


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def _server_link(stats, name="server", i=0):
    return stats["servers"][name]["links"][i]


def _halves_agree(client_link, server_link):
    """Both halves of one link: the same parties, the same dispatched
    steps, one final target."""
    assert client_link["parties"] == server_link["parties"]
    assert client_link["final_target"] is not None
    assert client_link["final_target"] == server_link["final_target"]
    assert client_link["steps"] == server_link["steps"] == client_link["final_target"]


def _expected_echo_crc(n_rpcs, payload):
    crc = 0
    for i in range(n_rpcs):
        req = f"m{i}:".encode() + bytes((i + j) % 256 for j in range(payload))
        crc = zlib.crc32(b"echo:" + req, crc)
    return crc


# -- tests/test_mc_link.py, on the port ---------------------------------------


def test_two_process_echo(fabric_pair):
    """RPCs echo across processes over the device plane; the cross-process
    wire acks advance; the close dance quiesces both sides cleanly."""
    stats, _ = fabric_pair
    assert stats["n_rpcs"] == 8
    assert stats["peer_ack"] > 0
    assert stats["steps"] >= stats["n_rpcs"]
    assert stats["final_target"] is not None
    # two DISTINCT parties — one rank per process (one device: the CPU)
    assert len({rank for rank, _ in stats["parties"]}) == 2
    assert {dev for _, dev in stats["parties"]} == {"cpu"}
    assert stats["row_device"] == "cpu"
    assert stats["echo_crc"] == _expected_echo_crc(8, 3000)
    _halves_agree(stats, _server_link(stats))


def test_two_process_echo_agrees_with_the_jax_harness(fabric_pair):
    """The JAX harness's pair with the same arguments: the same echoes,
    and the reference's assertions hold in both runs."""
    from incubator_brpc_tpu.transport.mc_worker import orchestrate_pair as jax_pair

    port, _ = fabric_pair
    ref, _, _ = jax_pair()
    for key in ("n_rpcs", "payload", "window", "slot_words"):
        assert port[key] == ref[key], key
    for stats in (port, ref):
        assert stats["peer_ack"] > 0
        assert stats["steps"] >= stats["n_rpcs"]
        assert stats["final_target"] is not None
    # the JAX client asserted every echo is b"echo:" + its request; the
    # port's CRC-32 over its echoes is that of the same bytes
    assert port["echo_crc"] == _expected_echo_crc(ref["n_rpcs"], ref["payload"])


def test_two_process_windowed_burst(fabric_pair):
    """Payloads spanning many slots under a small window: the lockstep
    credit (own undrained deliveries) pipelines without deadlock and
    without corrupting the re-cut byte stream."""
    stats, _ = mc_worker.orchestrate_pair(
        extra=("--n-rpcs", "4", "--payload", "20000", "--slot-words", "128", "--window", "2"),
        **CPU,
    )
    # 20000-byte echoes through 512-byte slots: many steps per RPC
    assert stats["steps"] > 40 * 4
    assert stats["peer_ack"] > 0
    assert stats["echo_crc"] == _expected_echo_crc(4, 20000)
    _halves_agree(stats, _server_link(stats))


def test_three_process_fabric(fabric_pair):
    """Client + TWO server processes in one job: a PartitionChannel fans
    each call over two cross-process links — the client rank holds a star
    of two-rank groups."""
    stats, _ = mc_worker.orchestrate_fabric(n_servers=2, extra=("--n-rpcs", "4"), **CPU)
    links = stats["links"]
    assert len(links) == 2
    # one client rank shared, two distinct server ranks
    assert len({tuple(lk["parties"][0]) for lk in links}) == 1
    assert len({lk["parties"][1][0] for lk in links}) == 2
    assert all(lk["peer_ack"] > 0 for lk in links)
    for lk in links:
        server = f"server{lk['parties'][1][0]}"
        _halves_agree(lk, _server_link(stats, server))


def test_peer_death_fails_link_fast(fabric_pair):
    """A server process that vanishes mid-traffic must fail the client's
    link promptly — via the host socket under the control stream, not a
    wedge timeout — and the in-flight RPC errors instead of hanging."""
    stats, transcript = mc_worker.orchestrate_peer_death(die_after=3, **CPU)
    # the client's connection warm-up consumes one server-side echo
    assert stats["ok_before_death"] >= 2, transcript
    assert stats["failed_at"] >= 2
    assert stats["error_code"] == ErrorCode.EFAILEDSOCKET, stats
    # fast: NOT the 30 s RPC deadline, NOT the 120 s wedge timer
    assert stats["fail_s"] < 10.0, stats
    assert "SERVER_DYING" in transcript


def test_probe_runs_a_two_process_collective():
    assert mc_worker.multiprocess_capable()
    records = mc_worker.orchestrate_probe(device="cpu", words=(64, 256), iters=5)
    assert [r["rank"] for r in records] == [0, 1]
    for r in records:
        assert sorted(r["widths"]) == ["256", "64"]
        # a CPU party has no device rows to stage
        assert all(w["host_exchange_ms"] > 0 and "staging_ms" not in w
                   for w in r["widths"].values())


@pytest.mark.parametrize("option", [
    ("--collective-steps", "32"), ("--mc-lowering-check",), ("--chaos-kill-at-step", "2"),
])
def test_session_options_wait_for_a4b(option):
    """The options that raised naming A4b run now that it landed: a pmean
    session over the fabric's three ranks, the fabric's PartitionChannel
    lowered to a one-step session, and a party killed at step 2 of a
    session that heals from a spare."""
    if option[0] == "--chaos-kill-at-step":
        stats, transcript = mc_worker.orchestrate_chaos_session(
            n_parties=3, steps=6, kill_at=int(option[1]), **CPU)
        assert stats["byte_identical"] and stats["replaced_party_ids"] == [2], transcript
        assert "SERVER_DYING" in transcript
        return
    stats, transcript = mc_worker.orchestrate_fabric(
        n_servers=2, extra=("--n-rpcs", "2", *option), **CPU)
    if option[0] == "--collective-steps":
        assert stats["collective"]["parties"] == 3, transcript
        assert stats["collective"]["steps"] == 32
    else:
        assert stats["mc_lowered"] == {"bytes": 2 * 48, "parties": 2}, transcript


def test_chip_smoke_phase_3e_on_the_cpu():
    import torch

    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, k1 = chip_smoke.mc_phase(torch, kernels, device="cpu")
    assert set(out) == {"stream", "pair", "pair_s", "burst", "probe", "fabric", "peer_death"}
    assert k1 == {"frame_rows": 0, "verify_rows": 0, "echo_step_rows": 0}  # no card, no launch
    assert out["pair"]["device_rpcs"] == chip_smoke.MC_DEVICE_RPCS
    assert out["peer_death"]["error_code"] == ErrorCode.EFAILEDSOCKET


# -- the control plane, in one process ------------------------------------------


class _Sink:
    """Messenger stand-in: keeps every byte delivered to its socket."""

    def __init__(self):
        self.data = bytearray()

    def process(self, sock):
        buf = sock._read_buf
        self.data += buf.to_bytes()
        buf.popn(len(buf))


class _Pair:
    """Two link halves in one process: ranks 3 and 5 over two gloo groups
    on one HashStore; each side's control messages reach the other's
    ``on_control`` in order through a queue and a pump thread (the control
    stream's ordered consumer). Clearing ``gate`` holds every control
    message until it is set again."""

    def __init__(self, tag, slot_words=64, window=2):
        store = dist.HashStore()
        self.queues = [queue.Queue(), queue.Queue()]
        self.sent = [[], []]
        self.links = [
            MultiControllerLink(
                side, ["cpu", "cpu"], [3, 5],
                lambda timeout, side=side: port_dist.make_pair_group(
                    dist.PrefixStore(tag, store), side, "gloo", timeout),
                slot_words=slot_words, window=window, wedge_timeout=30.0,
                control_send=lambda msg, side=side: self._send(side, msg),
            )
            for side in (0, 1)
        ]
        self.gate = threading.Event()
        self.gate.set()
        self.sinks = [_Sink(), _Sink()]
        self.socks = [DeviceSocket(self.links[i], i, messenger=self.sinks[i]) for i in (0, 1)]
        self.pumps = [threading.Thread(target=self._pump, args=(i,)) for i in (0, 1)]
        for t in self.pumps:
            t.start()

    def _send(self, side, msg):
        self.sent[side].append(dict(msg))
        self.queues[1 - side].put(json.loads(json.dumps(msg)))

    def _pump(self, side):
        while True:
            msg = self.queues[side].get()
            if msg is None:
                return
            assert self.gate.wait(timeout=20)
            self.links[side].on_control(msg)

    def wait(self, pred, timeout=20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.01)
        return pred()

    def closed(self):
        return all(lk._closed and lk.inflight_steps == 0 for lk in self.links)

    def stop(self):
        for lk in self.links:
            if not lk._closed:
                lk.fail("test over")
        for q in self.queues:
            q.put(None)
        for t in self.pumps:
            t.join(timeout=10)
            assert not t.is_alive()
        # the links' join and completion threads end with the links
        assert self.wait(lambda: not [t for t in threading.enumerate()
                                      if t.name.startswith("tbtorch-mclink")])


@pytest.fixture
def pair(request):
    p = _Pair(request.node.name)
    yield p
    p.stop()


def test_want_target_join_is_the_max_of_both_wants(pair):
    a = bytes(range(256)) * 3  # 768 B: 3 slots of 256 B
    b = b"q" * 2000  # 8 slots
    assert pair.socks[0].write(a) == 0
    assert pair.socks[1].write(b) == 0
    assert pair.wait(lambda: len(pair.sinks[1].data) == len(a) and len(pair.sinks[0].data) == len(b))
    assert bytes(pair.sinks[1].data) == a and bytes(pair.sinks[0].data) == b
    wants = [[m["n"] for m in pair.sent[side] if m["op"] == "want"] for side in (0, 1)]
    assert wants[0] and wants[1]
    # each announced want only grows, and both sides ran max(all wants)
    for w in wants:
        assert w == sorted(w)
    assert pair.wait(lambda: pair.links[0]._seq == pair.links[1]._seq == max(wants[0] + wants[1]))
    assert pair.links[0]._target == pair.links[1]._target == max(wants[0] + wants[1])
    assert pair.links[0].peer_ack > 0 and pair.links[1].peer_ack > 0


@pytest.mark.parametrize("order", ["client", "server", "both"])
def test_close_dance_agrees_on_one_final(pair, order):
    """``close_req`` from one side, the other, or both at once (each sent
    before the other arrives): both sides reach the same ``final`` and
    dispatch exactly that many steps."""
    assert pair.socks[0].write(b"x" * 500) == 0
    assert pair.socks[1].write(b"y" * 700) == 0
    assert pair.wait(lambda: len(pair.sinks[1].data) == 500 and len(pair.sinks[0].data) == 700)
    sides = {"client": (0,), "server": (1,), "both": (0, 1)}[order]
    pair.gate.clear()
    for side in sides:
        pair.links[side].close(side)
    pair.gate.set()
    assert pair.wait(pair.closed)
    finals = [lk._final_target for lk in pair.links]
    assert finals[0] is not None and finals[0] == finals[1]
    assert pair.links[0]._seq == pair.links[1]._seq == finals[0]
    assert all(lk._finished for lk in pair.links)
    reqs = [m for side in (0, 1) for m in pair.sent[side] if m["op"] == "close_req"]
    acks = [m for side in (0, 1) for m in pair.sent[side] if m["op"] == "close_ack"]
    assert len(reqs) == len(sides) and len(acks) >= 1


def test_close_with_the_peer_backlog_delivers_every_byte(pair):
    """The peer still has bytes queued when the close_req arrives: its
    close_ack raises the final so those bytes reach the wire."""
    big = bytes(range(256)) * 40  # 10240 B: 40 slots at window 2
    assert pair.socks[1].write(big) == 0
    pair.links[0].close(0)
    assert pair.wait(pair.closed)
    assert bytes(pair.sinks[0].data) == big
    assert pair.links[0]._final_target == pair.links[1]._final_target >= 40
    # after the freeze a send is refused
    assert pair.links[1].send(1, b"late") == ErrorCode.EFAILEDSOCKET


def test_a_link_refuses_one_rank_on_both_sides():
    with pytest.raises(ValueError, match="two distinct ranks"):
        MultiControllerLink(0, ["cpu", "cpu"], [2, 2], lambda timeout: None)


# -- the handshake's refusals ---------------------------------------------------


@pytest.fixture
def cpu_server():
    srv = port_rpc.Server(port_rpc.ServerOptions(device="cpu"))
    srv.add_service("Echo", {"echo": lambda cntl, req: req})
    assert srv.start(0)
    yield srv
    srv.stop()
    assert srv.join(timeout=10)


def test_handshake_needs_a_job(cpu_server):
    assert port_dist.current_job() is None
    ch = port_rpc.Channel()
    assert ch.init(
        f"127.0.0.1:{cpu_server.port}",
        options=port_rpc.ChannelOptions(transport="tpu", link_controller="multi",
                                        timeout_ms=10000, max_retry=0),
    )
    cntl = ch.call_method("Echo", "echo", b"x")
    assert cntl.error_code == ErrorCode.EFAILEDSOCKET
    assert "init_job" in cntl.error_text


@pytest.mark.parametrize("client_rank,backend,refusal", [
    (0, "gloo", "the same rank"),
    (1, "nccl", "backend 'nccl' proposed, this process's job runs 'gloo'"),
])
def test_handshake_refuses_one_rank_twice_and_a_foreign_backend(
        cpu_server, client_rank, backend, refusal):
    """The server's job is rank 0 of 2 on gloo; a proposal from rank 0, or
    on another backend, is refused before any link half is built."""
    from incubator_brpc_tpu_torch.transport.device_link import HANDSHAKE_METHOD, HANDSHAKE_SERVICE

    port_dist.init_job(0, 2, mc_worker._free_ports(1)[0], "cpu", backend="gloo")
    try:
        ch = port_rpc.Channel()
        assert ch.init(f"127.0.0.1:{cpu_server.port}")
        ctrl = port_rpc.stream_create()
        proposal = {"controller": "multi", "client_rank": client_rank, "client_device": "cpu",
                    "backend": backend, "group": "refused", "slot_words": 64, "window": 2}
        cntl = ch.call_method(HANDSHAKE_SERVICE, HANDSHAKE_METHOD, json.dumps(proposal).encode(),
                              request_stream=ctrl)
        assert cntl.error_code == ErrorCode.EREQUEST
        assert refusal in cntl.error_text
        assert ctrl.state == port_rpc.stream.CLOSED  # the half-open stream died with the RPC
        assert cpu_server._device_socks == []
    finally:
        port_dist.shutdown_job()
