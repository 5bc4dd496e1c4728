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
  own lockstep schedule.

On one card every process holds ``cuda:0``; NCCL refuses two ranks on one
card, so there the pair runs ``--backend gloo`` with the slot rows on the
card. ``--backend nccl`` across cards is written and not run.

Exit is the reference's: process 0 holds the store, so it must outlive
its peers. The client tells the servers it is done (``Admin.Quit``, a
plain TCP RPC) and exits; the parent closing a server's stdin is the
fallback exit. The session roles and options of the JAX harness
(``--collective-steps``, ``--mc-lowering-check``,
``--chaos-kill-at-step``) wait for ROADMAP A4b and raise naming it.

The collective-method plane's integer test kernels stay at the top of the
file: module-level so every party minting a DeviceMethod from them
resolves the SAME fingerprint (module.qualname + source + geometry).
Integer arithmetic end to end, so results are bit-exact across planes and
devices: ``session_expected`` is their host model, the bitwise oracle of
the session tests.
"""

from __future__ import annotations

import argparse
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


# -- the harness ------------------------------------------------------------

A4B = "is the collective session plane's, not in the port yet (ROADMAP A4b)"


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


def run_server(args) -> int:
    _init_distributed(args)
    from incubator_brpc_tpu_torch.rpc import Server, ServerOptions

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
    done = {"links": [_link_stats(lk) for lk in server._device_socks.links]}
    if endpoint is not None:
        from incubator_brpc_tpu_torch.ops import kernels

        assert endpoint.close(timeout=60)
        done["k1_launches"] = {n: kernels.launch_counts()[n]
                               for n in ("frame_rows", "verify_rows", "echo_step_rows")}
    print("SERVER_DONE " + json.dumps(done), flush=True)
    return 0


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
    links = [sub[0]._device_sock.link for sub in pc._subs]
    stats = {"n_rpcs": args.n_rpcs, "fanout_ms": 1e3 * fan_s / max(1, args.n_rpcs),
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
    group = link_group("probe", [0, 1], job.backend, 60.0)
    x = torch.tensor([job.rank + 1], dtype=torch.int32, device=job.device)
    outs = [torch.empty_like(x) for _ in range(2)]
    group.allgather([outs], [x]).wait()
    assert [int(o.item()) for o in outs] == [1, 2], outs
    out = {"rank": job.rank, "device": str(job.device), "backend": job.backend}
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
    print("PROBE_OK " + json.dumps(out), flush=True)
    return 0


def orchestrate_probe(device=None, backend="gloo", words=(256,), iters: int = 0,
                      timeout: float = 120.0):
    """Run the probe in two processes (``iters`` timed exchanges at each
    slot width in ``words``); returns each rank's PROBE_OK record."""
    import subprocess

    repo, env = _env()
    coord = _free_ports(1)[0]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "incubator_brpc_tpu_torch.transport.mc_worker", "probe",
             "--coord-port", str(coord), "--nprocs", "2", "--proc-id", str(i),
             "--probe-words", ",".join(map(str, words)), "--probe-iters", str(iters),
             *_device_args(device, backend)],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
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
    ap.add_argument("role", choices=["server", "client", "fabric-client", "probe"])
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
    # the collective session plane's options (ROADMAP A4b)
    ap.add_argument("--collective-steps", type=int, default=0)
    ap.add_argument("--mc-lowering-check", action="store_true")
    ap.add_argument("--chaos-kill-at-step", type=int, default=-1)
    args = ap.parse_args(argv)
    for name, unset in (("collective_steps", 0), ("mc_lowering_check", False),
                        ("chaos_kill_at_step", -1)):
        if getattr(args, name) != unset:
            raise NotImplementedError(f"--{name.replace('_', '-')} {A4B}")
    if args.proc_id < 0:
        # pair convention: the server holds the store, the client is last
        args.proc_id = 0 if args.role == "server" else args.nprocs - 1
    if args.role == "server":
        return run_server(args)
    if args.role == "fabric-client":
        return run_fabric_client(args)
    if args.role == "probe":
        return run_probe(args)
    return run_client(args)


if __name__ == "__main__":
    sys.exit(main())
