"""Multi-process harness for the multi-controller device plane, the
counterpart of ``incubator_brpc_tpu/transport/mc_worker.py``.

Runnable as ``python -m incubator_brpc_tpu_torch.transport.mc_worker <role>
...``. The processes form one job (``utils/distributed.py``): process 0
holds the job's store, every process is told its rank, its device
(``--device cpu`` or ``cuda:N``; the card when left out) and the backend of
its links (``--backend gloo`` or ``nccl``). Two shapes:

- the two-process PAIR (1 server + 1 client): one link, lockstep exchange
  (transport/mc_link.py) — the reference RDMA transport's deployment
  (rdma/rdma_endpoint.h:42-213, per-host init rdma_helper.cpp);
- the three-process FABRIC (2 servers + 1 fabric-client): a
  PartitionChannel fans one call out over TWO cross-process links — the
  client holds a star of links, each its own two-rank group running its
  own lockstep schedule; with ``--collective-steps`` it also runs a pmean
  session (``parallel/mc_collective.py``) over every rank, and with
  ``--mc-lowering-check`` a ParallelChannel call of a device method over
  the links lowers to a one-step session;
- the N-process SESSION (N-1 servers + 1 session-client): the client
  proposes sessions of the collective method plane
  (``parallel/mc_dispatch.py``) over plain host channels, one party per
  rank, the client a party too: the user kernel ``dsvc.scale`` at
  ``--width`` bytes (``--chunks``, ``--double-buffer``), checked byte for
  byte against ``session_expected``; with ``--quantize`` exact and
  quantized pmean sessions; ``--expect-reject`` against a server started
  with ``--wrong-kernel``; ``--expect-resume`` with ``--spare-procs`` and
  ``--checkpoint-every`` against a server started with
  ``--chaos-kill-at-step`` (its RPC server stops at that step while its
  process lives on).

On one card every process holds ``cuda:0``; NCCL refuses two ranks on one
card, so there the processes run ``--backend gloo`` with the rows on the
card. ``--backend nccl`` across cards is written and not run.

Exit is the reference's: process 0 holds the store, so it must outlive
its peers. The client tells the servers it is done (``Admin.Quit``, a
plain TCP RPC) and exits; the parent closing a server's stdin is the
fallback exit.

The collective-method plane's integer test kernels stay at the top of the
file: module-level so every party minting a DeviceMethod from them
resolves the SAME fingerprint (module.qualname + source + geometry).
Integer arithmetic end to end, so results are bit-exact across planes and
devices: ``session_expected`` is their host model, the bitwise oracle of
the session tests.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import threading
import time
import zlib

import numpy as np
import torch

SESSION_WIDTH = 512


def _scale_psum_kernel(data, n, axis):
    """psum + elementwise — a user kernel that actually exercises the
    party axis (``axis.psum``, the JAX kernel's ``lax.psum(x, "par")``)."""
    x = data.to(torch.int32)
    s = axis.psum(x)
    return ((3 * s + x) % 256).to(torch.uint8), n


def _scale_psum_kernel_wrong(data, n, axis):
    """Same name, different body — the divergence the fingerprint check
    must reject before any party enters lockstep."""
    x = data.to(torch.int32)
    s = axis.psum(x)
    return ((5 * s + x) % 256).to(torch.uint8), n


def session_expected(operands, steps: int, width: int = SESSION_WIDTH):
    """Host-side model of the K-step _scale_psum_kernel chain: exact
    integer arithmetic, so every party's device result must match these
    bytes bit-for-bit."""
    rows, ns = [], []
    for op in operands:
        row = np.zeros(width, np.int64)
        row[: len(op)] = np.frombuffer(op, np.uint8)
        rows.append(row)
        ns.append(len(op))
    x = np.stack(rows)
    for _ in range(steps):
        s = x.sum(axis=0)
        x = (3 * s[None, :] + x) % 256
    return [bytes(x[i, : ns[i]].astype(np.uint8)) for i in range(len(rows))]


def scale_operands(n: int, width: int = SESSION_WIDTH):
    """The session client's operands of ``dsvc.scale``, one per party and
    of different lengths (the operand routing and the n passthrough are
    part of what is checked): the JAX harness's ``64 + 8 i`` bytes at
    ``SESSION_WIDTH``, ``width - 8 i`` bytes at a wider row; byte j of
    party i is ``(7 i + j) % 256``."""
    lens = [64 + 8 * i if width == SESSION_WIDTH else width - 8 * i for i in range(n)]
    return [((7 * i + np.arange(k)) % 256).astype(np.uint8).tobytes()
            for i, k in enumerate(lens)]


def pmean_rows(n: int, width: int = SESSION_WIDTH):
    """The quantized role's float32 operands (the JAX harness's, seed
    1234): party i's row is standard normal times ``1 + i``."""
    rng = np.random.default_rng(1234)
    return [(rng.standard_normal(width // 4) * (1.0 + i)).astype(np.float32) for i in range(n)]


def pmean_model(rows, steps: int) -> np.ndarray:
    """The exact pmean chain in float32 with the parties added in order
    (0, 1, ...), then divided by their count: what every party's row of an
    exact ``_collective.pmean`` session equals, byte for byte, in both
    forms of the party axis."""
    cur = [np.asarray(r, np.float32) for r in rows]
    for _ in range(int(steps)):
        m = cur[0].copy()
        for r in cur[1:]:
            m += r
        m = m / np.float32(len(cur))
        cur = [m] * len(cur)
    return cur[0]


# -- the harness ------------------------------------------------------------


def _init_distributed(args) -> None:
    """Join the job: rank ``--proc-id`` of ``--nprocs``, the store on
    ``--coord-port`` (held by rank 0), this process's ``--device`` and
    ``--backend``."""
    from incubator_brpc_tpu_torch.utils.distributed import init_job

    init_job(args.proc_id, args.nprocs, args.coord_port, args.device, backend=args.backend)


def _link_stats(link) -> dict:
    """One link half's record: the parties as (rank, device), the steps it
    dispatched, the peer's cumulative ack, the agreed final step count, and
    the host time per exchange."""
    return {
        "parties": [list(p) for p in link.parties()],
        "steps": int(link._seq),
        "peer_ack": int(link.peer_ack),
        "final_target": link._final_target,
        "window": link.window,
        "slot_words": link.slot_words,
        "row_device": str(link.row_device),
        "exchanges": link.exchanges,
        "exchange_ms": 1e3 * link.exchange_s / max(1, link.exchanges),
    }


class _AcceptedLinks(list):
    """The server's list of accepted device sockets, keeping every link
    half it ever held so the server can report them at exit (the server
    drops a socket from the list when it fails)."""

    def __init__(self):
        super().__init__()
        self.links = []

    def append(self, ds) -> None:
        self.links.append(ds.link)
        super().append(ds)


def _k2_launches() -> dict:
    from incubator_brpc_tpu_torch.ops import kernels

    counts = kernels.launch_counts()
    return {name: counts[name] for name in ("quantize_rows", "dequant_mean_rows")}


def _gathers() -> dict:
    """This process's session-group gathers so far and their host time."""
    from incubator_brpc_tpu_torch.parallel import mesh

    return {"gathers": mesh.party_gathers.get_value(),
            "gather_ms": mesh.party_gather_us.get_value() / 1e3}


def run_server(args) -> int:
    _init_distributed(args)
    from incubator_brpc_tpu_torch.rpc import Server, ServerOptions
    from incubator_brpc_tpu_torch.rpc import device_method as _device_method

    quit_ev = threading.Event()

    def _quit(cntl, req: bytes) -> bytes:
        quit_ev.set()
        return b"bye"

    server = Server(ServerOptions(device=args.device))
    server._device_socks = _AcceptedLinks()
    served = [0]

    def _echo(cntl, req: bytes) -> bytes:
        served[0] += 1
        if args.die_after_rpcs and served[0] > args.die_after_rpcs:
            # fault injection: the host vanishes mid-request — no response,
            # no close dance, no clean exit (os._exit skips atexit)
            print("SERVER_DYING", flush=True)
            os._exit(42)
        return b"echo:" + req

    server.add_service("EchoService", {"Echo": _echo})
    pid = args.proc_id
    server.add_service("part", {"get": lambda cntl, req: b"p%d:" % pid + req})
    # a user-registered device method for the collective method plane:
    # sessions name ("dsvc", "scale") and every party fingerprint-checks
    # it; --wrong-kernel swaps the body to prove the mismatch reject
    kernel = _scale_psum_kernel_wrong if args.wrong_kernel else _scale_psum_kernel
    server.add_service(
        "dsvc", {"scale": _device_method(kernel, width=args.width, chunkable=True)}
    )
    if args.chaos_kill_at_step >= 0:
        _arm_chaos(server, args.chaos_kill_at_step)
    server.add_service("Admin", {"Quit": _quit})
    endpoint = None
    if args.device_echo:
        from incubator_brpc_tpu_torch.ops import kernels
        from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint

        endpoint = DeviceEndpoint(device=args.device, window_size=16, max_batch=16)
        server.add_service("tensor", {"echo": endpoint.server_handler()})
        kernels.reset_launch_counts()
    assert server.start(args.rpc_port)
    print(f"SERVER_READY port={server.port}", flush=True)
    # the parent closing our stdin is the fallback exit (client crashed)
    threading.Thread(target=lambda: (sys.stdin.read(), quit_ev.set()), daemon=True).start()
    quit_ev.wait()
    server.stop()
    server.join(timeout=10)
    done = {"links": [_link_stats(lk) for lk in server._device_socks.links],
            "k2_launches": _k2_launches(), **_gathers()}
    if endpoint is not None:
        from incubator_brpc_tpu_torch.ops import kernels

        assert endpoint.close(timeout=60)
        done["k1_launches"] = {n: kernels.launch_counts()[n]
                               for n in ("frame_rows", "verify_rows", "echo_step_rows")}
    print("SERVER_DONE " + json.dumps(done), flush=True)
    return 0


def _arm_chaos(server, kill_at: int) -> None:
    """The deterministic chaos drill: this party "dies" at step
    ``kill_at`` of its first session — its RPC server stops (connections
    fail, so the proposer classifies a death) while the PROCESS stays
    alive, and the local session is aborted so its handler ends now."""
    from incubator_brpc_tpu_torch.parallel import mc_dispatch as mcd

    fired = threading.Event()

    def die() -> None:
        print("SERVER_DYING", flush=True)
        server.stop()
        mcd.abort_sessions_for_owner(server, "chaos drill killed this party")

    def hook(step: int, own_index: int) -> None:
        if step >= kill_at and not fired.is_set():
            fired.set()
            threading.Thread(target=die, daemon=True).start()
            # park until the stop lands so no further step of the doomed
            # chain dispatches past the kill point
            time.sleep(0.2)

    mcd.set_step_hook(hook)


def _device_echo_calls(ch, n: int) -> int:
    """``n`` calls of the server's device echo table (256 B each, seeded)
    over the link, each answer byte for byte its request."""
    from incubator_brpc_tpu_torch.rpc import Controller

    rng = np.random.default_rng(5)
    for i in range(n):
        req = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        cntl = ch.call_method("tensor", "echo", req, cntl=Controller(timeout_ms=60000))
        assert cntl.ok(), f"device echo {i} failed: {cntl.error_text}"
        assert cntl.response_payload == req, f"device echo {i} corrupt"
    return n


def _wait_closed(links, timeout: float = 20.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(lk._closed and lk.inflight_steps == 0 for lk in links):
            return True
        time.sleep(0.05)
    return False


def run_client(args) -> int:
    _init_distributed(args)
    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Controller

    ch = Channel()
    assert ch.init(
        f"127.0.0.1:{args.rpc_port}",
        options=ChannelOptions(
            transport="tpu",
            link_controller="multi",
            timeout_ms=60000,
            link_slot_words=args.slot_words,
            link_window=args.window,
        ),
    )
    # the peer may not have bound its RPC port yet — retry the first call
    # until the server is up (a refused bootstrap surfaces as a failed
    # controller, not a raise)
    deadline = time.monotonic() + 60.0
    while True:
        first = ch.call_method("EchoService", "Echo", b"hello", cntl=Controller(timeout_ms=60000))
        if first.ok():
            break
        if time.monotonic() > deadline:
            print(f"CLIENT_FAIL connect: {first.error_text}", flush=True)
            return 1
        time.sleep(0.2)
    assert first.response_payload == b"echo:hello"

    if args.expect_peer_death:
        return _run_client_peer_death(args, ch)
    link = ch._device_sock.link
    crc = 0
    seq0 = link._seq
    t0 = time.perf_counter()
    for i in range(args.n_rpcs):
        body = bytes((i + j) % 256 for j in range(args.payload))
        req = f"m{i}:".encode() + body
        cntl = ch.call_method("EchoService", "Echo", req, cntl=Controller(timeout_ms=60000))
        assert cntl.ok(), f"echo {i} failed: {cntl.error_text}"
        assert cntl.response_payload == b"echo:" + req, f"echo {i} corrupt"
        crc = zlib.crc32(cntl.response_payload, crc)
    echo_s = time.perf_counter() - t0
    echo_steps = link._seq - seq0
    device_rpcs = _device_echo_calls(ch, args.device_rpcs) if args.device_rpcs else 0

    stats = {"n_rpcs": args.n_rpcs, "payload": args.payload, "echo_crc": crc,
             "echo_ms": 1e3 * echo_s / max(1, args.n_rpcs),
             "echo_steps_per_s": echo_steps / echo_s, "device_rpcs": device_rpcs,
             **_link_stats(link)}
    # the cross-host drain signal must actually flow: the peer's
    # cumulative-delivered count rides slot words 3+5 back to us
    assert stats["peer_ack"] > 0, "wire acks never advanced"
    assert stats["steps"] >= args.n_rpcs, "fewer steps than RPCs?"
    # clean shutdown: the close dance agrees on a final step count, both
    # sides dispatch exactly that many, and the link quiesces
    ch._device_sock.recycle()
    assert _wait_closed([link]), "close dance did not finish"
    stats.update(_link_stats(link))
    print("CLIENT_OK " + json.dumps(stats), flush=True)
    _quit_servers([args.rpc_port])
    return 0


def run_fabric_client(args) -> int:
    """Three-process fabric: this client holds TWO multi-controller links
    (one per server process) and a PartitionChannel splits each call
    across them — the N-party star over real processes."""
    _init_distributed(args)
    from incubator_brpc_tpu_torch.rpc import ChannelOptions, Controller, PartitionChannel

    ports = [int(p) for p in args.rpc_ports.split(",")]
    n = len(ports)
    url = "list://" + ",".join(f"127.0.0.1:{p} {i}/{n}" for i, p in enumerate(ports))
    pc = PartitionChannel()
    assert pc.init(
        url,
        partition_count=n,
        options=ChannelOptions(
            transport="tpu",
            link_controller="multi",
            timeout_ms=60000,
            link_slot_words=args.slot_words,
            link_window=args.window,
        ),
    )
    expected = b"".join(f"p{i}:X".encode() for i in range(n))
    deadline = time.monotonic() + 90.0
    while True:
        cntl = pc.call_method("part", "get", b"X", cntl=Controller(timeout_ms=60000))
        if cntl.ok() and cntl.response_payload == expected:
            break
        if time.monotonic() > deadline:
            print(f"CLIENT_FAIL fabric: {cntl.error_text}", flush=True)
            return 1
        time.sleep(0.3)
    t0 = time.perf_counter()
    for i in range(args.n_rpcs):
        body = b"%04d" % i
        cntl = pc.call_method("part", "get", body, cntl=Controller(timeout_ms=60000))
        assert cntl.ok(), f"fabric rpc {i}: {cntl.error_text}"
        want = b"".join(b"p%d:" % j + body for j in range(n))
        assert cntl.response_payload == want, f"fabric rpc {i} merged wrong"
    fan_s = time.perf_counter() - t0
    coll = _fabric_collective(args, ports) if args.collective_steps > 0 else None
    mc_low = _mc_lowering_check(args, pc, n) if args.mc_lowering_check else None
    links = [sub[0]._device_sock.link for sub in pc._subs]
    stats = {"n_rpcs": args.n_rpcs, "fanout_ms": 1e3 * fan_s / max(1, args.n_rpcs),
             "collective": coll, "mc_lowered": mc_low,
             "links": [_link_stats(lk) for lk in links]}
    # one client rank shared, one distinct server rank per link: the star
    assert len({tuple(lk["parties"][0]) for lk in stats["links"]}) == 1
    assert len({lk["parties"][1][0] for lk in stats["links"]}) == len(ports)
    assert all(lk["peer_ack"] > 0 for lk in stats["links"])
    pc.stop()
    for sub in pc._subs:
        sub[0]._device_sock.recycle()
    assert _wait_closed(links), "a link's close dance hung"
    stats["links"] = [_link_stats(lk) for lk in links]
    print("CLIENT_OK " + json.dumps(stats), flush=True)
    _quit_servers(ports)
    return 0


def _fabric_collective(args, ports) -> dict:
    """A pipelined pmean session (``mc_collective.propose_collective``)
    over every rank of the job, the client a party: every party must end
    at the global mean."""
    from incubator_brpc_tpu_torch.parallel.mc_collective import expected_mean, propose_collective
    from incubator_brpc_tpu_torch.utils.distributed import current_job

    job = current_job()
    party_ids = list(range(job.world_size))
    chans = _connect_all(ports)
    out = propose_collective(chans, party_ids, party_ids.index(job.rank),
                             steps=args.collective_steps, width=256, seed=7, device=job.device)
    want = expected_mean(7, len(party_ids), 256)
    assert np.allclose(out["own"], want, atol=1e-5), "no convergence"
    want_sum = float(np.sum(want, dtype=np.float64))
    for cs in out["server_checksums"]:
        assert abs(cs - want_sum) < 1e-3, (cs, want_sum)
    return {"steps": args.collective_steps, "parties": len(party_ids),
            "per_step_ms": out["elapsed_s"] / args.collective_steps * 1e3}


def _mc_lowering_check(args, pc, n: int) -> dict:
    """A call of a device method through the PartitionChannel over
    multi-controller links: it cannot run as one dispatch across
    processes, so it lowers to a one-step session over the servers' ranks
    (``rpc/combo.py`` -> ``mc_dispatch.lower_parallel_call``)."""
    from incubator_brpc_tpu_torch.rpc import Controller
    from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod, register_device_method

    # the PROPOSER validates against its local registry too
    register_device_method(
        "dsvc", "scale", DeviceMethod(_scale_psum_kernel, width=args.width, chunkable=True)
    )
    req = bytes(range(48))
    cntl = pc.call_method("dsvc", "scale", req, cntl=Controller(timeout_ms=60000))
    assert cntl.ok(), f"mc-lowered call failed: {cntl.error_text}"
    assert getattr(cntl, "collective_fused", False), (
        "mc lowering not taken (fell back to host fan-out)"
    )
    want = b"".join(session_expected([req] * n, steps=1, width=args.width))
    assert cntl.response_payload == want, "mc-lowered merge diverged"
    return {"bytes": len(cntl.response_payload), "parties": n}


def _connect_all(ports, deadline_s: float = 90.0):
    """One warm host channel per server port, retrying the first echo
    until each server has bound. Returns the channels or None after
    printing CLIENT_FAIL."""
    from incubator_brpc_tpu_torch.rpc import Channel, Controller

    chans = []
    deadline = time.monotonic() + deadline_s
    for p in ports:
        hc = Channel()
        assert hc.init(f"127.0.0.1:{p}")
        while True:
            c = hc.call_method("EchoService", "Echo", b"up", cntl=Controller(timeout_ms=60000))
            if c.ok():
                break
            if time.monotonic() > deadline:
                print(f"CLIENT_FAIL connect {p}: {c.error_text}", flush=True)
                return None
            time.sleep(0.2)
        chans.append(hc)
    return chans


def _quit_servers(ports) -> None:
    """Release every server (see run_server) — the one shutdown protocol,
    shared by every client role."""
    from incubator_brpc_tpu_torch.rpc import Channel, Controller

    for p in ports:
        host = Channel()
        assert host.init(f"127.0.0.1:{p}")
        host.call_method("Admin", "Quit", b"", cntl=Controller(timeout_ms=10000))


def run_session_client(args) -> int:
    """N-party collective-method-plane client: propose K-step sessions of
    the user-registered ("dsvc", "scale") kernel to every server process
    over plain host channels (no device links: the session IS the data
    plane), run its own party's chain, and check every party's row byte
    for byte against the integer model; then the roles its options ask
    for. Prints CLIENT_OK with every session's figures."""
    _init_distributed(args)
    from incubator_brpc_tpu_torch.parallel.mc_dispatch import propose_dispatch
    from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod, register_device_method
    from incubator_brpc_tpu_torch.utils.distributed import current_job

    job = current_job()
    # the proposer validates (service, method) against its LOCAL registry
    # exactly like every accepting party
    register_device_method(
        "dsvc", "scale", DeviceMethod(_scale_psum_kernel, width=args.width, chunkable=True)
    )
    ports = [int(p) for p in args.rpc_ports.split(",")]
    spare_procs = {int(p) for p in args.spare_procs.split(",") if p != ""}
    # spare parties stand OUTSIDE the initial session: their ranks leave
    # the party set and their channels form the standby pool the elastic
    # recovery path heals dead slots from; server i is rank i
    party_ids = [r for r in range(job.world_size) if r not in spare_procs]
    client_index = party_ids.index(job.rank)
    n = len(party_ids)
    assert len(ports) == n - 1 + len(spare_procs)
    all_chans = _connect_all(ports)
    if all_chans is None:
        return 1
    chans = [ch for i, ch in enumerate(all_chans) if i not in spare_procs]
    spares = [(ch, i) for i, ch in enumerate(all_chans) if i in spare_procs]
    operands = scale_operands(n, args.width)
    steps = args.collective_steps or 4
    if args.expect_resume:
        return _run_session_client_resume(args, chans, spares, party_ids, client_index,
                                          operands, steps, ports)
    if args.expect_reject:
        # one server registered a different body under the same name: the
        # accept phase must reject CLEANLY, before any lockstep entry
        try:
            propose_dispatch(chans, party_ids, "dsvc", "scale", operands, steps=steps,
                             proposer_index=client_index, timeout_ms=60000, device=job.device)
        except RuntimeError as e:
            assert "fingerprint mismatch" in str(e), e
            from incubator_brpc_tpu_torch.parallel.mc_dispatch import dispatch_sessions

            print("CLIENT_OK " + json.dumps({"rejected": True, "parties": n,
                                             "sessions_run": dispatch_sessions.get_value()}),
                  flush=True)
            _quit_servers(ports)
            return 0
        print("CLIENT_FAIL mismatch was not rejected", flush=True)
        return 1
    g0 = _gathers()
    out = propose_dispatch(chans, party_ids, "dsvc", "scale", operands, steps=steps,
                           proposer_index=client_index, timeout_ms=120000,
                           chunks=args.chunks, double_buffer=args.double_buffer,
                           device=job.device)
    g1 = _gathers()
    want = session_expected(operands, out["final_steps"], args.width)
    for i, (got, exp) in enumerate(zip(out["results"], want)):
        assert got == exp, f"party {i} diverged from the integer model"
    stats = {"parties": n, "steps": out["final_steps"], "width": args.width,
             "per_step_ms": out["elapsed_s"] / out["final_steps"] * 1e3,
             "party_ms_per_step": [e / out["final_steps"] * 1e3 for e in out["party_elapsed_s"]],
             "gather_ms_per_step": (g1["gather_ms"] - g0["gather_ms"]) / out["final_steps"],
             "method": "dsvc.scale", "chunks": args.chunks,
             "double_buffer": bool(args.double_buffer)}
    if args.quantize != "none":
        stats["pmean"] = _run_session_client_quantized(args, chans, party_ids, client_index, steps)
    stats.update(k2_launches=_k2_launches(), **_gathers())
    print("CLIENT_OK " + json.dumps(stats), flush=True)
    _quit_servers(ports)
    return 0


def _run_session_client_quantized(args, chans, party_ids, client_index, steps) -> dict:
    """The quantized role (``--quantize int8``, ``int4`` or both,
    comma-separated): the SAME float32 operands through an exact pmean
    session and a quantized one per mode, then the bytes-on-wire ratio
    (quantized / exact) and the max |quantized - exact|, which must sit
    inside ``parallel/quantized.pmean_error_bound``; the exact session
    must equal the party-ordered f32 mean and each quantized one
    ``np_quantized_pmean``, byte for byte."""
    from incubator_brpc_tpu_torch.parallel import quantized as Q
    from incubator_brpc_tpu_torch.parallel.mc_collective import _pmean_dm
    from incubator_brpc_tpu_torch.parallel.mc_dispatch import propose_dispatch
    from incubator_brpc_tpu_torch.rpc.device_method import register_device_method
    from incubator_brpc_tpu_torch.utils.distributed import current_job

    device = current_job().device
    n = len(party_ids)
    register_device_method("_collective", "pmean", _pmean_dm(args.width))
    rows = pmean_rows(n, args.width)
    operands = [r.tobytes() for r in rows]
    # the overlap schedule rides along when asked: every session runs the
    # SAME schedule so the comparison isolates quantization
    sched = dict(chunks=args.chunks, double_buffer=args.double_buffer)

    def session(mode):
        """One session and this party's figures of it: ms a step (its own
        chain's and every party's), its gathers (exact: the f32 row once
        a step; quantized: the values, then the exponents) and their
        time, its K2 launches."""
        before, g0 = _k2_launches(), _gathers()
        out = propose_dispatch(chans, party_ids, "_collective", "pmean", operands, steps=steps,
                               proposer_index=client_index, timeout_ms=120000, quantize=mode,
                               device=device, **sched)
        after, g1 = _k2_launches(), _gathers()
        k = out["final_steps"]
        return out, {"ms_per_step": out["elapsed_s"] / k * 1e3,
                     "party_ms_per_step": [e / k * 1e3 for e in out["party_elapsed_s"]],
                     "gathers": g1["gathers"] - g0["gathers"],
                     "gather_ms_per_step": (g1["gather_ms"] - g0["gather_ms"]) / k,
                     "k2": {name: after[name] - before[name] for name in after},
                     "bitwise_model": True}

    exact, res_exact = session("none")
    final = exact["final_steps"]
    if any(r != pmean_model(rows, final).tobytes() for r in exact["results"]):
        raise AssertionError("the exact pmean session differs from the party-ordered f32 mean")
    res = {"none": res_exact}
    for mode in args.quantize.split(","):
        quant, res[mode] = session(mode)
        assert quant["final_steps"] == final
        bound = Q.pmean_error_bound(rows, final, mode)
        want = Q.np_quantized_pmean(rows, final, mode).tobytes()
        max_err = max(float(np.abs(np.frombuffer(g, np.float32) - np.frombuffer(r, np.float32)).max())
                      for g, r in zip(quant["results"], exact["results"]))
        if max_err > bound or any(g != want for g in quant["results"]):
            raise AssertionError(f"{mode}: error {max_err} (bound {bound}), bitwise model "
                                 f"{[g == want for g in quant['results']]}")
        res[mode].update(wire_ratio=quant["wire_bytes"] / exact["wire_bytes"],
                         max_error=max_err, error_bound=bound)
    return res


def _run_session_client_resume(args, chans, spares, party_ids, client_index, operands, steps,
                               ports) -> int:
    """Chaos-drill client half: one party dies at exactly step K
    (``--chaos-kill-at-step`` on its server); the session must HEAL — the
    spare fills the dead slot — and the merged result must be
    byte-identical to an undisturbed run. Across processes the dead
    party's checkpoint ring went with its RPC server, so the heal lands as
    a full restart over the replaced set (``resumed_from`` None) unless
    another ring holds its row: the drill asserts the heal and reports the
    resume point it achieved."""
    from incubator_brpc_tpu_torch.parallel.mc_dispatch import propose_with_recovery
    from incubator_brpc_tpu_torch.utils.distributed import current_job

    out = propose_with_recovery(
        chans, party_ids, "dsvc", "scale", operands, steps=steps,
        proposer_index=client_index, timeout_ms=120000, session_deadline_ms=60000,
        max_reproposals=1, spares=spares, checkpoint_every=args.checkpoint_every or 2,
        device=current_job().device,
    )
    want = session_expected(operands, out["final_steps"], args.width)
    if any(got != exp for got, exp in zip(out["results"], want)):
        print("CLIENT_FAIL resumed merge diverged from the model", flush=True)
        return 1
    if not out["replaced_party_ids"]:
        print(f"CLIENT_FAIL no heal: replaced={out['replaced_party_ids']} "
              f"resumed_from={out['resumed_from']}", flush=True)
        return 1
    stats = {"parties": len(party_ids), "steps": out["final_steps"],
             "resumed_from": out["resumed_from"], "dead_party_ids": out["dead_party_ids"],
             "replaced_party_ids": out["replaced_party_ids"], "byte_identical": True,
             "method": "dsvc.scale"}
    print("CLIENT_OK " + json.dumps(stats), flush=True)
    _quit_servers(ports)
    return 0


def _free_ports(n: int):
    import socket

    holders, ports = [], []
    for _ in range(n):
        sk = socket.socket()
        sk.bind(("127.0.0.1", 0))
        ports.append(sk.getsockname()[1])
        holders.append(sk)
    for sk in holders:
        sk.close()
    return ports


def _env():
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return repo, env


def _orchestrate(specs, label: str, timeout: float, servers_may_die=False):
    """Shared parent-side runner: spawn every (name, role, args) worker,
    collect outputs (the client LAST in ``specs`` is the one whose
    CLIENT_OK carries the stats), assert success, return (stats,
    transcript). The exit is worker-coordinated (Admin.Quit);
    communicate() closing stdin is the fallback when the client crashed
    early."""
    import subprocess

    repo, env = _env()
    procs = []
    for name, role, argv in specs:
        procs.append((name, subprocess.Popen(
            [sys.executable, "-m", "incubator_brpc_tpu_torch.transport.mc_worker", role, *argv],
            cwd=repo, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )))
    client_name, client = procs[-1]
    outs = {}
    try:
        outs[client_name], _ = client.communicate(timeout=timeout)
        for name, proc in procs[:-1]:
            outs[name], _ = proc.communicate(timeout=30.0)
    except subprocess.TimeoutExpired:
        for name, proc in procs:
            proc.kill()
        for name, proc in procs:
            if name not in outs:
                outs[name] = (proc.communicate()[0] or "") + " [KILLED]"
        raise AssertionError(
            f"{label} timed out\n" + "".join(f"-- {n} --\n{o}\n" for n, o in outs.items())
        )
    transcript = "".join(f"-- {n} --\n{o}\n" for n, o in outs.items())
    assert client.returncode == 0 and "CLIENT_OK" in outs[client_name], (
        f"{label} client failed rc={client.returncode}\n{transcript}"
    )
    servers = {}
    for name, proc in procs[:-1]:
        if servers_may_die:
            continue
        assert proc.returncode == 0 and "SERVER_DONE" in outs[name], (
            f"{label} {name} failed rc={proc.returncode}\n{transcript}"
        )
        servers[name] = json.loads(outs[name].split("SERVER_DONE", 1)[1].strip().splitlines()[0])
    stats = json.loads(outs[client_name].split("CLIENT_OK", 1)[1].strip().splitlines()[0])
    stats["servers"] = servers
    return stats, transcript


def _run_client_peer_death(args, ch) -> int:
    """Fault-injection client half: the peer dies mid-traffic. The link
    must FAIL fast, via the host socket under the control stream (not a
    wedge), failing the in-flight RPC, and the dead link must not poison
    the process."""
    from incubator_brpc_tpu_torch.rpc import Controller
    from incubator_brpc_tpu_torch.transport.sock import CONNECTED

    ok_count = 0
    failed_at = None
    for i in range(args.n_rpcs):
        t0 = time.monotonic()
        cntl = ch.call_method(
            "EchoService", "Echo", b"f%03d" % i, cntl=Controller(timeout_ms=30000, max_retry=0)
        )
        if cntl.ok():
            ok_count += 1
        else:
            failed_at = (i, cntl.error_code, cntl.error_text, time.monotonic() - t0)
            break
    assert failed_at is not None, "peer died but no RPC ever failed"
    link = ch._device_sock.link
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline and not link._closed:
        time.sleep(0.05)
    assert link._closed, "link did not fail after peer death"
    assert ch._device_sock.state != CONNECTED
    print("CLIENT_OK " + json.dumps({
        "ok_before_death": ok_count, "failed_at": failed_at[0], "error_code": failed_at[1],
        "error_text": failed_at[2], "fail_s": failed_at[3],
    }), flush=True)
    # the peer is dead and its half of the link with it: skip atexit (the
    # clean exit path is covered by the non-fault runs)
    sys.stdout.flush()
    os._exit(0)


def _device_args(device, backend):
    args = ["--backend", backend]
    if device is not None:
        args += ["--device", device]
    return tuple(args)


def orchestrate_pair(extra=(), timeout: float = 120.0, device=None, backend="gloo",
                     server_extra=()):
    """Spawn the server+client pair as real OS processes and collect the
    client's link stats (with the server's under ``servers``). Returns
    ``(stats, transcript)``."""
    coord, rpc = _free_ports(2)
    base = ("--coord-port", str(coord), "--rpc-port", str(rpc), *_device_args(device, backend))
    return _orchestrate(
        [("server", "server", (*base, *server_extra)), ("client", "client", (*base, *extra))],
        label="two-process pair", timeout=timeout,
    )


def orchestrate_peer_death(die_after: int = 3, timeout: float = 120.0, device=None,
                           backend="gloo"):
    """Fault-injection pair: the SERVER process dies mid-traffic (os._exit
    inside a handler). The client must observe a fast, clean link failure.
    The client is rank 0 here, so the job's store survives the death it is
    reporting on."""
    coord, rpc = _free_ports(2)
    base = ("--coord-port", str(coord), "--rpc-port", str(rpc), *_device_args(device, backend))
    specs = [
        ("server", "server", (*base, "--proc-id", "1", "--die-after-rpcs", str(die_after))),
        ("client", "client", (*base, "--proc-id", "0", "--n-rpcs", str(die_after + 20),
                              "--expect-peer-death")),
    ]
    return _orchestrate(specs, label="peer-death pair", timeout=timeout, servers_may_die=True)


def orchestrate_fabric(n_servers: int = 2, extra=(), timeout: float = 120.0, device=None,
                       backend="gloo"):
    """Spawn ``n_servers`` server processes + one fabric client (all in one
    job) and return the client's per-link stats."""
    ports = _free_ports(n_servers + 1)
    coord, rpc_ports = ports[0], ports[1:]
    nprocs = n_servers + 1
    dev = _device_args(device, backend)
    specs = [
        (f"server{i}", "server", ("--coord-port", str(coord), "--nprocs", str(nprocs),
                                  "--proc-id", str(i), "--rpc-port", str(rpc_ports[i]), *dev))
        for i in range(n_servers)
    ]
    specs.append(("fabric-client", "fabric-client", (
        "--coord-port", str(coord), "--nprocs", str(nprocs), "--proc-id", str(n_servers),
        "--rpc-ports", ",".join(map(str, rpc_ports)), *dev, *extra,
    )))
    return _orchestrate(specs, label="fabric", timeout=timeout)


def orchestrate_session(n_parties: int = 3, steps: int = 4, wrong_kernel: bool = False,
                        timeout: float = 300.0, chunks: int = 1, double_buffer: bool = False,
                        quantize: str = "none", device=None, backend="gloo",
                        width: int = SESSION_WIDTH):
    """Spawn ``n_parties - 1`` server processes + one session client (one
    job) and run an N-party session of the user kernel at ``width``
    bytes, one party per rank. ``wrong_kernel`` arms ONE server with a
    same-name/different-body kernel so the fingerprint reject is what the
    run proves. ``chunks``/``double_buffer`` run the session on the
    overlap schedule; ``quantize`` ("int8", "int4" or "int8,int4") adds
    the exact and quantized pmean sessions. Returns (the client's stats,
    with each server's SERVER_DONE record under ``servers``, transcript)."""
    ports = _free_ports(n_parties)
    coord, rpc_ports = ports[0], ports[1:]
    dev = _device_args(device, backend)
    common = ("--coord-port", str(coord), "--nprocs", str(n_parties), "--width", str(width), *dev)
    specs = []
    for i in range(n_parties - 1):
        argv = [*common, "--proc-id", str(i), "--rpc-port", str(rpc_ports[i])]
        if wrong_kernel and i == 0:
            argv.append("--wrong-kernel")
        specs.append((f"server{i}", "server", tuple(argv)))
    client = [*common, "--proc-id", str(n_parties - 1),
              "--rpc-ports", ",".join(map(str, rpc_ports)), "--collective-steps", str(steps),
              "--chunks", str(chunks), "--quantize", quantize]
    if double_buffer:
        client.append("--double-buffer")
    if wrong_kernel:
        client.append("--expect-reject")
    specs.append(("session-client", "session-client", tuple(client)))
    return _orchestrate(specs, label=f"{n_parties}-party session", timeout=timeout)


def orchestrate_chaos_session(n_parties: int = 3, steps: int = 8, kill_at: int = 3,
                              checkpoint_every: int = 2, timeout: float = 300.0, device=None,
                              backend="gloo", width: int = SESSION_WIDTH):
    """The scriptable chaos drill: ``n_parties - 1`` party servers + ONE
    spare server + the session client, one job. Server 0 is armed with
    ``--chaos-kill-at-step kill_at`` so exactly one party dies at step K;
    the client runs ``propose_with_recovery`` with the spare in its
    standby pool and asserts the session HEALS byte-identically. Returns
    the client's stats (resumed_from, replaced_party_ids,
    byte_identical)."""
    n_servers = n_parties  # n_parties - 1 party servers + 1 spare
    ports = _free_ports(n_servers + 1)
    coord, rpc_ports = ports[0], ports[1:]
    nprocs = n_servers + 1
    spare_proc = n_servers - 1  # the LAST server process is the spare
    common = ("--coord-port", str(coord), "--nprocs", str(nprocs), "--width", str(width),
              *_device_args(device, backend))
    specs = []
    for i in range(n_servers):
        argv = [*common, "--proc-id", str(i), "--rpc-port", str(rpc_ports[i])]
        if i == 0:
            argv += ["--chaos-kill-at-step", str(kill_at)]
        specs.append((f"server{i}", "server", tuple(argv)))
    client = [*common, "--proc-id", str(nprocs - 1),
              "--rpc-ports", ",".join(map(str, rpc_ports)), "--collective-steps", str(steps),
              "--spare-procs", str(spare_proc), "--expect-resume",
              "--checkpoint-every", str(checkpoint_every)]
    specs.append(("session-client", "session-client", tuple(client)))
    return _orchestrate(specs, label=f"chaos session (kill party 0 at step {kill_at})",
                        timeout=timeout, servers_may_die=True)


def run_probe(args) -> int:
    """Capability probe body: join the job, build one link group with the
    other rank, run ONE allgather of the ranks and check it; with
    ``--probe-iters N``, also time N exchanges of a slot row of each width
    in ``--probe-words`` (slot words, + 8 header words) on this process's
    device and on the host, the difference being what the backend's
    staging of device rows costs. Prints PROBE_OK and the times."""
    _init_distributed(args)
    from incubator_brpc_tpu_torch.utils.distributed import current_job, link_group

    job = current_job()
    out = {"rank": job.rank, "device": str(job.device), "backend": job.backend}
    if job.rank < 2:  # the link part: ranks 0 and 1
        _probe_link(args, job, link_group("probe", [0, 1], job.backend, 60.0), out)
    if args.probe_axis:
        out["axis"] = _probe_axis(job, [int(b) for b in args.probe_axis_bytes.split(",") if b],
                                  args.probe_iters)
    print("PROBE_OK " + json.dumps(out), flush=True)
    return 0


def _probe_link(args, job, group, out) -> None:
    x = torch.tensor([job.rank + 1], dtype=torch.int32, device=job.device)
    outs = [torch.empty_like(x) for _ in range(2)]
    group.allgather([outs], [x]).wait()
    assert [int(o.item()) for o in outs] == [1, 2], outs
    if args.probe_iters:
        out["widths"] = {}
        for words in [int(w) for w in args.probe_words.split(",")]:
            rec = out["widths"][words] = {}
            for where in ("device", "host") if job.device.type == "cuda" else ("host",):
                dev = job.device if where == "device" else torch.device("cpu")
                row = torch.full((8 + words,), job.rank, dtype=torch.int32, device=dev)
                got = [torch.empty_like(row) for _ in range(2)]
                for _ in range(3):
                    group.allgather([got], [row]).wait()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.probe_iters):
                    group.allgather([got], [row]).wait()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                rec[f"{where}_exchange_ms"] = 1e3 * (time.perf_counter() - t0) / args.probe_iters
                assert int(got[1 - job.rank][0]) == 1 - job.rank
            if "device_exchange_ms" in rec:
                rec["staging_ms"] = rec["device_exchange_ms"] - rec["host_exchange_ms"]


AXIS_DTYPES = ("float32", "int32", "int8", "uint8")


def axis_probe_rows(rank: int, dtype: str) -> np.ndarray:
    """Party ``rank``'s row ``[1, 64]`` of ``dtype`` in the axis probe,
    seeded by the rank (floats standard normal times ``rank + 1``)."""
    rng = np.random.default_rng(100 + rank)
    if dtype == "float32":
        return (rng.standard_normal((1, 64)) * (rank + 1)).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, (1, 64), endpoint=True).astype(dtype)


def _probe_axis(job, sizes=(), iters: int = 0) -> dict:
    """The distributed party axis over a session group of every rank:
    ``all_gather`` of this rank's row in every dtype a session moves (the
    gathered dtype must be the row's: a widened gather moves more bytes
    than the session's wire accounting says) and ``psum`` of the float and
    int32 rows, their bytes base64; with ``sizes`` and ``iters``, the time
    of one ``all_gather`` of a uint8 row of each size (bytes a party) on
    this process's device (gloo stages it) and on the host, the first on
    the group apart from ``iters`` more."""
    from incubator_brpc_tpu_torch.parallel.mesh import DistributedPartyAxis
    from incubator_brpc_tpu_torch.utils.distributed import session_group

    n = job.world_size
    group = session_group("probe-axis", 0, list(range(n)), job.backend, 60.0)
    axis = DistributedPartyAxis(size=n, index=job.rank, group=group, device=job.device)
    rec = {}
    for dtype in AXIS_DTYPES:
        row = torch.from_numpy(axis_probe_rows(job.rank, dtype)).to(job.device)
        g = axis.all_gather(row)
        assert g.dtype == row.dtype and tuple(g.shape) == (n, 64), (g.dtype, g.shape)
        rec[f"gather_{dtype}"] = base64.b64encode(g.cpu().numpy().tobytes()).decode()
        if dtype in ("float32", "int32"):
            rec[f"psum_{dtype}"] = base64.b64encode(
                axis.psum(row).cpu().numpy().tobytes()).decode()
    cuda = job.device.type == "cuda"
    host_axis = DistributedPartyAxis(size=n, index=job.rank, group=group,
                                     device=torch.device("cpu"))
    for nbytes in sizes if iters else ():
        for where in ("device", "host") if cuda else ("host",):
            dev = torch.device("cpu") if where == "host" else job.device
            ax = host_axis if where == "host" else axis
            row = torch.full((1, nbytes), job.rank, dtype=torch.uint8, device=dev)

            def gather(ax=ax, row=row):
                ax.all_gather(row)
                if cuda:
                    torch.cuda.synchronize()

            t0 = time.perf_counter()
            gather()
            first = time.perf_counter() - t0
            gather()
            t0 = time.perf_counter()
            for _ in range(iters):
                gather()
            rec[f"{where}_{nbytes}"] = {"first_ms": first * 1e3,
                                        "ms": (time.perf_counter() - t0) / iters * 1e3}
    return rec


def orchestrate_probe(device=None, backend="gloo", words=(256,), iters: int = 0,
                      timeout: float = 120.0, axis: bool = False, axis_bytes=(),
                      nprocs: int = 2):
    """Run the probe in ``nprocs`` processes: the link part on ranks 0 and 1
    (``iters`` timed exchanges at each slot width in ``words``); with
    ``axis``, the distributed party axis over every rank (``iters`` timed
    gathers at each row size in ``axis_bytes``); returns each rank's
    PROBE_OK record."""
    import subprocess

    repo, env = _env()
    coord = _free_ports(1)[0]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "incubator_brpc_tpu_torch.transport.mc_worker", "probe",
             "--coord-port", str(coord), "--nprocs", str(nprocs), "--proc-id", str(i),
             "--probe-words", ",".join(map(str, words)), "--probe-iters", str(iters),
             *(("--probe-axis", "--probe-axis-bytes", ",".join(map(str, axis_bytes)))
               if axis else ()), *_device_args(device, backend)],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(nprocs)
    ]
    records = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out = (p.communicate()[0] or "") + " [KILLED]"
        if p.returncode != 0 or "PROBE_OK" not in out:
            for q in procs:
                q.kill()
            raise AssertionError(f"probe failed rc={p.returncode}\n{out}")
        records.append(json.loads(out.split("PROBE_OK", 1)[1].strip().splitlines()[0]))
    return records


_mp_capable: dict = {}


def multiprocess_capable(timeout: float = 120.0) -> bool:
    """Can this torch build run a two-process gloo collective on the CPU?
    One tiny probe decides; cached process-wide."""
    if "ok" not in _mp_capable:
        try:
            orchestrate_probe(device="cpu", timeout=timeout)
            _mp_capable["ok"] = True
        except AssertionError:
            _mp_capable["ok"] = False
    return _mp_capable["ok"]


def main(argv=None) -> int:
    # SIGUSR1 dumps all thread stacks — the pair runs under an orchestration
    # harness, and a wedged worker must be diagnosable
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)
    ap = argparse.ArgumentParser()
    ap.add_argument("role", choices=["server", "client", "fabric-client", "session-client",
                                     "probe"])
    ap.add_argument("--coord-port", type=int, required=True, help="the job store's port (rank 0 holds it)")
    ap.add_argument("--rpc-port", type=int, default=0)
    ap.add_argument("--rpc-ports", type=str, default="")  # fabric client
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--proc-id", type=int, default=-1)  # -1: by role
    ap.add_argument("--device", default=None, help="cpu or cuda:N (default: the card)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo")
    ap.add_argument("--n-rpcs", type=int, default=8)
    ap.add_argument("--payload", type=int, default=3000)
    ap.add_argument("--slot-words", type=int, default=256)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--die-after-rpcs", type=int, default=0)  # server fault
    ap.add_argument("--expect-peer-death", action="store_true")  # client
    ap.add_argument("--device-echo", action="store_true")  # server: mount the device echo table
    ap.add_argument("--device-rpcs", type=int, default=0)  # client: calls of it over the link
    ap.add_argument("--probe-iters", type=int, default=0)  # probe: timed exchanges
    ap.add_argument("--probe-words", type=str, default="256")  # probe: their slot widths
    ap.add_argument("--probe-axis", action="store_true")  # probe: the distributed party axis
    ap.add_argument("--probe-axis-bytes", type=str, default="")  # probe: its timed row sizes
    # the collective session plane (parallel/mc_dispatch.py, mc_collective.py)
    ap.add_argument("--width", type=int, default=SESSION_WIDTH)  # session row bytes
    ap.add_argument("--collective-steps", type=int, default=0)  # fabric / session client
    ap.add_argument("--wrong-kernel", action="store_true")  # server
    ap.add_argument("--expect-reject", action="store_true")  # session client
    ap.add_argument("--mc-lowering-check", action="store_true")  # fabric client
    ap.add_argument("--chaos-kill-at-step", type=int, default=-1)  # server
    ap.add_argument("--spare-procs", type=str, default="")  # session client
    ap.add_argument("--expect-resume", action="store_true")  # session client
    ap.add_argument("--checkpoint-every", type=int, default=0)  # session client
    ap.add_argument("--chunks", type=int, default=1)  # session client
    ap.add_argument("--double-buffer", action="store_true")  # session client
    # session client: exact vs int8/int4 pmean (one mode, or both comma-separated)
    ap.add_argument("--quantize", type=str, default="none")
    args = ap.parse_args(argv)
    modes = args.quantize.split(",")
    if args.quantize != "none" and not set(modes) <= {"int8", "int4"}:
        ap.error(f"--quantize {args.quantize}: none, or int8 and/or int4")
    if args.proc_id < 0:
        # pair convention: the server holds the store, the client is last
        args.proc_id = 0 if args.role == "server" else args.nprocs - 1
    if args.role == "server":
        return run_server(args)
    if args.role == "fabric-client":
        return run_fabric_client(args)
    if args.role == "session-client":
        return run_session_client(args)
    if args.role == "probe":
        return run_probe(args)
    return run_client(args)


if __name__ == "__main__":
    sys.exit(main())
