"""rpc_press — load generator for tbus_std servers (reference
tools/rpc_press: drives a method at a target qps/concurrency and reports
qps + latency percentiles).

Usage:
    python -m incubator_brpc_tpu_torch.tools.rpc_press --server 127.0.0.1:8000 \
        --method demo.echo --payload-bytes 64 --threads 8 --duration 5

The port's copy of the JAX package's ``tools/rpc_press.py``: the same
flags, functions and printed lines, over the port's planes. The target is
any server that speaks tbus_std (either package's); ``--transport tpu``
rides device links to a server whose links live on its device (the card,
or the CPU where the server runs on ``ServerOptions(device="cpu")``).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time


def _trace_schedule(trace_sample_rate: float):
    """Counter-scheduled trace stamping (exact-rate, like the fault
    seam): returns ``(every, trace_id, next_span_id)`` — every
    ``every``'th operation carries the run's trace id, a fresh span id,
    and the head-based ``sampled`` bit, so one command produces a
    coherent fleet-observable traced flood.  ``every`` is 0 when the
    rate is 0 (untraced run)."""
    import itertools
    import random

    if trace_sample_rate <= 0:
        return 0, 0, None
    every = max(1, round(1.0 / trace_sample_rate))
    trace_id = random.getrandbits(63) | 1
    counter = itertools.count()

    def next_span_id():
        # one shared counter across every worker thread: seq % every == 0
        # elects, seq + 1 is the traced call's distinct span id
        seq = next(counter)
        return (seq + 1) if seq % every == 0 else 0

    return every, trace_id, next_span_id


def run_press(
    server: str,
    service: str,
    method: str,
    payload: bytes,
    threads: int = 4,
    duration: float = 5.0,
    timeout_ms: float = 1000,
    transport: str = "tcp",
    native_plane: bool = False,
    fault_rate: float = 0.0,
    fault_delay_ms: float = 0.0,
    compress_type: str = "",
    auth_token: str = "",
    trace_sample_rate: float = 0.0,
) -> dict:
    from incubator_brpc_tpu_torch.bvar import LatencyRecorder
    from incubator_brpc_tpu_torch.rpc import (
        Channel,
        ChannelOptions,
        Controller,
        TokenAuthenticator,
    )

    if fault_rate > 0 or fault_delay_ms > 0:
        # one-command brownout run: arm the deterministic fault seam of
        # WHICHEVER plane carries the traffic. Python plane: the
        # FaultInjector at the Socket.write seam (rpc/fault_injector.py).
        # Native plane: the tb_channel_set_fault counter schedule — every
        # round(1/rate)'th call fails/delays in C++, so --native-plane
        # brownout runs keep the interpreter off the path. Both live behind
        # the same fault_injection master flag.
        from incubator_brpc_tpu_torch.utils.flags import set_flag_unchecked

        set_flag_unchecked("fault_injection", True)
        if native_plane:
            from incubator_brpc_tpu_torch.transport.native_plane import (
                install_native_client_fault,
            )

            install_native_client_fault(
                fail_every=(
                    max(1, round(1.0 / fault_rate)) if fault_rate > 0 else 0
                ),
                delay_every=1 if fault_delay_ms > 0 else 0,
                delay_ms=int(fault_delay_ms),
            )
            print(
                "native-plane fault seam armed (counter schedule: "
                f"fail every {max(1, round(1.0 / fault_rate)) if fault_rate > 0 else 0}"
                f", delay {fault_delay_ms:g} ms/call)",
                file=sys.stderr,
            )
        else:
            from incubator_brpc_tpu_torch.rpc import (
                FaultInjector,
                install_socket_injector,
            )

            install_socket_injector(
                FaultInjector(
                    error_rate=fault_rate,
                    delay_rate=1.0 if fault_delay_ms > 0 else 0.0,
                    delay_ms=fault_delay_ms,
                )
            )

    # compressed/authenticated floods drive the NATIVE client seam when
    # --native-plane is set: the credential and compress_type stamp the
    # PRPC meta in C++ (baidu_std is the protocol that carries both), so
    # one command floods a native target with production-shaped frames
    proto = "baidu_std" if (compress_type or auth_token) else "tbus_std"
    ch = Channel()
    if not ch.init(
        server,
        options=ChannelOptions(
            timeout_ms=timeout_ms,
            transport=transport,
            native_plane=native_plane,
            protocol=proto,
            auth=TokenAuthenticator([auth_token]) if auth_token else None,
        ),
    ):
        raise SystemExit(f"cannot init channel to {server}")

    # counter-scheduled traced flood: every Nth call carries the run's
    # trace id + a fresh span id + the head-based sampled bit — a traced
    # flood is one command, and the whole run is one fleet-assemblable
    # trace (rpc_view --trace <id> --targets ...)
    trace_every, run_trace_id, next_span_id = _trace_schedule(
        trace_sample_rate
    )
    if trace_every:
        print(
            f"traced flood: every {trace_every}th call carries "
            f"trace {run_trace_id:x} (sampled bit set)",
            file=sys.stderr,
        )
    latency = LatencyRecorder(name=None)
    stop_at = time.monotonic() + duration
    counts = {"ok": 0, "fail": 0}
    lock = threading.Lock()

    def worker():
        ok = fail = 0
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            cntl = None
            if compress_type:
                cntl = Controller()
                cntl.compress_type = compress_type
            if trace_every:
                span = next_span_id()
                if span:
                    cntl = cntl or Controller()
                    cntl.trace_id = run_trace_id
                    cntl.span_id = span
                    cntl.trace_sampled = 1
            cntl = ch.call_method(service, method, payload, cntl=cntl)
            if cntl.ok():
                ok += 1
                latency << (time.perf_counter() - t0) * 1e6
            else:
                fail += 1
        with lock:
            counts["ok"] += ok
            counts["fail"] += fail

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.monotonic() - t0
    return {
        "qps": counts["ok"] / wall if wall else 0.0,
        "ok": counts["ok"],
        "fail": counts["fail"],
        "latency_us_avg": latency.latency(),
        "latency_us_p50": latency.latency_percentile(0.5),
        "latency_us_p99": latency.latency_percentile(0.99),
        "latency_us_max": latency.max_latency(),
        "trace_id": run_trace_id,
    }


def run_reactor_press(
    server: str,
    service: str,
    method: str,
    payload: bytes,
    reactors: int,
    conns_per_reactor: int = 2,
    duration: float = 5.0,
    timeout_ms: float = 1000,
    fault_rate: float = 0.0,
    fault_delay_ms: float = 0.0,
    compress_type: str = "",
    auth_token: str = "",
    trace_sample_rate: float = 0.0,
) -> dict:
    """Sharded-accept load run: ``reactors * conns_per_reactor`` native
    client channels (each pinned to its own client reactor shard at
    connect) flood the target concurrently, then the target's
    ``/vars`` is scraped for the ``native_reactor_<port>_<i>_conns``
    family so the per-reactor connection distribution — and any skew in
    the accept sharding — is printed next to the qps numbers.  The
    ``--fault-rate``/``--fault-delay-ms`` brownout flags arm the native
    client fault seam (tb_channel_set_fault) on every channel, exactly
    like ``--native-plane`` runs."""
    import re

    from incubator_brpc_tpu_torch.bvar import LatencyRecorder
    from incubator_brpc_tpu_torch.transport.native_plane import (
        NET_AVAILABLE,
        NativeClientChannel,
        install_native_client_fault,
    )

    if not NET_AVAILABLE:
        raise SystemExit("--reactors needs the native plane (libtbutil.so)")
    if fault_rate > 0 or fault_delay_ms > 0:
        from incubator_brpc_tpu_torch.utils.flags import set_flag_unchecked

        set_flag_unchecked("fault_injection", True)
        install_native_client_fault(
            fail_every=(
                max(1, round(1.0 / fault_rate)) if fault_rate > 0 else 0
            ),
            delay_every=1 if fault_delay_ms > 0 else 0,
            delay_ms=int(fault_delay_ms),
        )
        print(
            "native-plane fault seam armed on every reactor channel "
            f"(fail every "
            f"{max(1, round(1.0 / fault_rate)) if fault_rate > 0 else 0}, "
            f"delay {fault_delay_ms:g} ms/call)",
            file=sys.stderr,
        )
    ip, _, port = server.rpartition(":")
    nconns = max(1, reactors) * max(1, conns_per_reactor)
    # compressed/authenticated floods speak baidu_std (the protocol that
    # carries compress_type/authentication_data) on the NATIVE client
    # seam: the payload compresses ONCE here, the credential and codec id
    # stamp every frame's RpcMeta in C++
    production = bool(compress_type or auth_token)
    proto = "baidu_std" if production else "tbus_std"
    chans = [
        NativeClientChannel(ip, int(port), protocol=proto)
        for _ in range(nconns)
    ]
    if production:
        from incubator_brpc_tpu_torch.protocol import compress as compress_mod

        if compress_type:
            payload = compress_mod.compress(compress_type, payload)
        for ch in chans:
            if auth_token:
                ch.set_auth(auth_token)
            if compress_type:
                ch.set_request_compress(compress_type)
    # traced floods on the REACTOR path stamp the native client seam
    # directly: the trace fields ride each traced call's RpcRequestMeta
    # (or tbus JSON meta) and the server's C++ cutter keeps them on the
    # fast path — same counter schedule as the plain path
    trace_every, run_trace_id, next_span_id = _trace_schedule(
        trace_sample_rate
    )
    if trace_every:
        print(
            f"traced flood: every {trace_every}th call carries "
            f"trace {run_trace_id:x} (sampled bit set)",
            file=sys.stderr,
        )
    latency = LatencyRecorder(name=None)
    stop_at = time.monotonic() + duration
    counts = {"ok": 0, "fail": 0}
    lock = threading.Lock()

    def worker(ch):
        ok = fail = 0
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            span = next_span_id() if trace_every else 0
            rc, err, _meta, _body = ch.call(
                service, method, payload, timeout_ms=int(timeout_ms),
                trace_id=run_trace_id if span else 0,
                span_id=span, sampled=1 if span else 0,
            )
            if rc >= 0 and err == 0:
                ok += 1
                latency << (time.perf_counter() - t0) * 1e6
            else:
                fail += 1
        with lock:
            counts["ok"] += ok
            counts["fail"] += fail

    ts = [threading.Thread(target=worker, args=(ch,)) for ch in chans]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.monotonic() - t0
    # scrape the distribution while our connections are still open — a
    # closed channel leaves the reactor's conn gauge before we read it
    distribution = {}
    try:
        text = _http_get(server, "/vars", timeout=2.0)
        # anchored to THIS port: a process serving several native ports
        # exposes a native_reactor_* family per port, and merging them
        # would misreport the very skew this print exists to surface
        for m in re.finditer(
            rf"native_reactor_{int(port)}_(\d+)_conns\s*:\s*(\d+)", text
        ):
            distribution[int(m.group(1))] = int(m.group(2))
    except OSError:
        pass  # no portal reachable: fall back to client-side pins below
    misroutes = sum(ch.cid_misroutes() for ch in chans)
    client_shards = [ch.reactor for ch in chans]
    for ch in chans:
        ch.close()
    return {
        "qps": counts["ok"] / wall if wall else 0.0,
        "ok": counts["ok"],
        "fail": counts["fail"],
        "latency_us_avg": latency.latency(),
        "latency_us_p50": latency.latency_percentile(0.5),
        "latency_us_p99": latency.latency_percentile(0.99),
        "latency_us_max": latency.max_latency(),
        "reactor_conns": distribution,
        "client_shards": client_shards,
        "cid_misroutes": misroutes,
        "trace_id": run_trace_id,
    }


def _http_get(server: str, path: str, timeout: float = 5.0) -> str:
    """One ad-hoc HTTP GET against the target's builtin portal (every
    server serves it on its RPC port).  Servers may hold the connection
    open after the response (keep-alive on handed-off native
    connections), so the read stops once Content-Length is satisfied; a
    timeout is tolerated ONLY for a complete (or length-less) body — a
    server stalling mid-body still raises instead of returning silently
    truncated output."""
    import re as _re
    import socket as _socket

    ip, _, port = server.rpartition(":")
    with _socket.create_connection((ip, int(port)), timeout=timeout) as s:
        s.sendall(
            f"GET {path} HTTP/1.0\r\nHost: {server}\r\n\r\n".encode()
        )
        out = b""
        expect = None  # total bytes once headers + Content-Length known
        while expect is None or len(out) < expect:
            if expect is None and b"\r\n\r\n" in out:
                head, _, _rest = out.partition(b"\r\n\r\n")
                m = _re.search(
                    rb"^content-length:\s*(\d+)\s*$", head,
                    _re.IGNORECASE | _re.MULTILINE,
                )
                if m:
                    expect = len(head) + 4 + int(m.group(1))
                    continue
            try:
                chunk = s.recv(4096)
            except _socket.timeout:
                if expect is None and out:
                    break  # no Content-Length: best effort, data in hand
                raise  # nothing yet, or a server stalled mid-body
            if not chunk:
                break
            out += chunk
    return out.decode(errors="replace")


def run_lame_duck_drill(
    server: str,
    service: str,
    method: str,
    payload: bytes,
    threads: int = 4,
    duration: float = 5.0,
    timeout_ms: float = 1000,
    grace_s: float = 0.0,
) -> dict:
    """Drain-under-load in one command: flood the target, trigger its
    ``/quitquitquit`` builtin a third of the way in, keep pressing until
    the server is gone, and classify what the clients saw.  A clean
    lame-duck drain shows ZERO connection-reset-class failures: in-flight
    RPCs finish, refreshed work gets retriable ELOGOFF, and only after
    the drain completes do connects start being refused (not counted —
    the workers stop at the first connect-refused-class error after the
    trigger)."""
    import threading as _threading

    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.utils.status import ErrorCode

    grace = grace_s if grace_s > 0 else max(1.0, duration * 0.5)
    ch = Channel()
    if not ch.init(
        server, options=ChannelOptions(timeout_ms=timeout_ms, max_retry=0)
    ):
        raise SystemExit(f"cannot init channel to {server}")
    RESET_CODES = frozenset(
        {ErrorCode.EFAILEDSOCKET, ErrorCode.EEOF, ErrorCode.ECLOSE}
    )
    events = []  # (issue time, completion time, kind) across every worker
    lock = _threading.Lock()
    triggered = _threading.Event()
    stop_at = time.monotonic() + duration

    def worker():
        local = []
        while time.monotonic() < stop_at:
            issued = time.monotonic()
            cntl = ch.call_method(service, method, payload)
            code = cntl.error_code
            now = time.monotonic()
            if code == 0:
                local.append((issued, now, "ok"))
            elif code == ErrorCode.ELOGOFF:
                local.append((issued, now, "logoff"))
            elif code in RESET_CODES or code == ErrorCode.EHOSTDOWN:
                local.append((issued, now, "conn"))
                if triggered.is_set():
                    break  # the server is gone: the drill is over
            else:
                local.append((issued, now, "other"))
        with lock:
            events.extend(local)

    ts = [_threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    time.sleep(duration * 0.3)
    print(
        f"triggering /quitquitquit?grace_s={grace:g} on {server}",
        file=sys.stderr,
    )
    status = _http_get(server, f"/quitquitquit?grace_s={grace:g}")
    # the server answered the trigger: it was in lame duck by now, so a
    # call issued from here on can only be refused, never admitted
    lame_at = time.monotonic()
    triggered.set()
    status_line = status.splitlines()[0] if status else "<empty response>"
    if " 200 " not in status_line:
        print(f"quitquitquit answered: {status_line}", file=sys.stderr)
        if " 403 " in status_line:
            print(
                "hint: the target must run with the enable_quitquitquit "
                "flag on (default off)",
                file=sys.stderr,
            )
        # no drain was triggered: stop the flood and report the refusal
        # instead of classifying a drill that never ran
        for t in ts:
            t.join()
        return {
            "ok": 0, "logoff": 0, "reset": 0, "other": 0,
            "drained_clean": False, "trigger_failed": status_line,
        }
    for t in ts:
        t.join()
    # Classification: a RESET is a connection-class failure of work the
    # drain should have finished or refused.  A call issued before the
    # trigger was answered may have been admitted: cutting it is dirty
    # draining, with no allowance (a grace-expiry hard stop cutting slow
    # in-flight handlers included).  A call issued after it can only be
    # refused: it is a reset when it was issued more than a guard band
    # before the last served ok/ELOGOFF, i.e. the server left it
    # unanswered while answering later work.  Connection failures of
    # calls issued within the guard band are the shutdown boundary: the
    # final close racing the last writes, or connects refused on the
    # now-stopped server — the drill ending, not dirty draining.  The
    # band is the slowest refusal of a call issued after the trigger (at least
    # GUARD_S): a call cut at the close was issued less than one refusal's
    # round trip before it, and on a loaded host that round trip outgrows
    # any fixed band.
    GUARD_S = 0.05
    served = [done for _i, done, k in events if k in ("ok", "logoff")]
    last_served = max(served) if served else 0.0
    guard = max(
        [GUARD_S]
        + [done - issued for issued, done, k in events if k == "logoff" and issued >= lame_at]
    )
    cut = [issued for issued, _d, k in events if k == "conn"]
    boundary = [last_served - issued for issued in cut
                if issued >= lame_at and issued >= last_served - guard]
    counts = {
        "ok": sum(1 for _i, _d, k in events if k == "ok"),
        "logoff": sum(1 for _i, _d, k in events if k == "logoff"),
        "reset": len(cut) - len(boundary),
        "other": sum(1 for _i, _d, k in events if k == "other"),
        # the band, and the boundary cuts it let pass with the oldest of
        # them (ms before the last answer; negative: issued after it)
        "guard_ms": guard * 1e3,
        "boundary": len(boundary),
        "boundary_oldest_ms": max(boundary, default=0.0) * 1e3,
    }
    counts["drained_clean"] = counts["reset"] == 0 and counts["other"] == 0
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--server", required=True, help="ip:port or naming url")
    p.add_argument("--method", required=True, help="service.method")
    p.add_argument("--payload-bytes", type=int, default=64)
    p.add_argument("--payload-file", help="read request payload from a file")
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--duration", type=float, default=5.0, help="seconds")
    p.add_argument("--timeout-ms", type=float, default=1000)
    p.add_argument(
        "--transport", choices=("tcp", "tpu"), default="tcp",
        help="tpu = drive the load over device links (the rdma_performance "
        "client's use_rdma flag)",
    )
    p.add_argument(
        "--native-plane", action="store_true",
        help="route eligible calls through the C++ client channel",
    )
    p.add_argument(
        "--reactors", type=int, default=0,
        help="sharded-accept load: open REACTORS * CONNS_PER_REACTOR "
        "native channels (each pinned to its own client reactor shard) "
        "and print the server's per-reactor connection distribution so "
        "skewed sharding is visible",
    )
    p.add_argument(
        "--conns-per-reactor", type=int, default=2,
        help="connections per reactor group for --reactors runs",
    )
    p.add_argument(
        "--compress-type", choices=("none", "snappy", "gzip", "zlib1"),
        default="none",
        help="compress request payloads with this codec (baidu_std wire "
        "compress_type; with --native-plane or --reactors the flood rides "
        "the C++ client seam end to end — compressed once, stamped per "
        "frame in C++)",
    )
    p.add_argument(
        "--auth-token", default="",
        help="authenticate the flood with this bearer token "
        "(authentication_data on the first request per connection; pair "
        "with a server running TokenAuthenticator)",
    )
    p.add_argument(
        "--trace-sample-rate", type=float, default=0.0,
        help="stamp trace context (run trace id, fresh span id, the "
        "head-based sampled bit) on this fraction of calls — "
        "counter-scheduled exact rate like the fault seam, on both the "
        "plain and --reactors load paths; the run's trace id is printed "
        "so `rpc_view --trace <id> --targets ...` can assemble it",
    )
    p.add_argument(
        "--fault-rate", type=float, default=0.0,
        help="inject transport-write failures on this fraction of "
        "operations (deterministic counter schedule; drives the "
        "FaultInjector so brownout runs are one command)",
    )
    p.add_argument(
        "--fault-delay-ms", type=float, default=0.0,
        help="inject this write-path delay (every operation) — latency "
        "brownout for limiter/timeout tuning",
    )
    p.add_argument(
        "--lame-duck-drill", action="store_true",
        help="drain-under-load in one command: flood the target, trigger "
        "its /quitquitquit a third of the way in, and report what the "
        "clients saw (a clean drain = zero connection-reset errors). "
        "TERMINATES the target server.",
    )
    p.add_argument(
        "--lame-duck-grace-s", type=float, default=0.0,
        help="grace window passed to /quitquitquit (0 = half the press "
        "duration)",
    )
    args = p.parse_args(argv)

    service, _, method = args.method.rpartition(".")
    if not service:
        p.error("--method must be service.method")
    if args.payload_file:
        with open(args.payload_file, "rb") as f:
            payload = f.read()
    else:
        payload = b"x" * args.payload_bytes

    if args.lame_duck_drill:
        counts = run_lame_duck_drill(
            args.server,
            service,
            method,
            payload,
            threads=args.threads,
            duration=args.duration,
            timeout_ms=args.timeout_ms,
            grace_s=args.lame_duck_grace_s,
        )
        print(
            f"ok={counts['ok']} logoff={counts['logoff']} "
            f"reset={counts['reset']} other={counts['other']} "
            f"drained_clean={counts['drained_clean']}"
        )
        return 0 if counts["drained_clean"] else 1

    if args.reactors > 0:
        if args.transport == "tpu":
            p.error("--reactors drives TCP native channels; it cannot "
                    "combine with --transport tpu")
        stats = run_reactor_press(
            args.server,
            service,
            method,
            payload,
            reactors=args.reactors,
            conns_per_reactor=args.conns_per_reactor,
            duration=args.duration,
            timeout_ms=args.timeout_ms,
            fault_rate=args.fault_rate,
            fault_delay_ms=args.fault_delay_ms,
            compress_type=(
                "" if args.compress_type == "none" else args.compress_type
            ),
            auth_token=args.auth_token,
            trace_sample_rate=args.trace_sample_rate,
        )
        if stats["reactor_conns"]:
            dist = " ".join(
                f"r{i}={n}" for i, n in sorted(stats["reactor_conns"].items())
            )
        else:  # no portal on the target: show the client-side pins
            dist = "client-shards=" + ",".join(
                str(s) for s in stats["client_shards"]
            )
        print(f"per-reactor conns: {dist}", file=sys.stderr)
        if stats["cid_misroutes"]:
            print(
                f"cid misroutes observed: {stats['cid_misroutes']}",
                file=sys.stderr,
            )
        print(
            f"qps={stats['qps']:.0f} ok={stats['ok']} fail={stats['fail']} "
            f"avg={stats['latency_us_avg']:.0f}us "
            f"p50={stats['latency_us_p50']:.0f}us "
            f"p99={stats['latency_us_p99']:.0f}us "
            f"max={stats['latency_us_max']:.0f}us"
        )
        if args.fault_rate > 0 or args.fault_delay_ms > 0:
            return 0  # failures are the point of a brownout run
        return 0 if stats["fail"] == 0 else 1

    stats = run_press(
        args.server,
        service,
        method,
        payload,
        threads=args.threads,
        duration=args.duration,
        timeout_ms=args.timeout_ms,
        transport=args.transport,
        native_plane=args.native_plane,
        fault_rate=args.fault_rate,
        fault_delay_ms=args.fault_delay_ms,
        compress_type=(
            "" if args.compress_type == "none" else args.compress_type
        ),
        auth_token=args.auth_token,
        trace_sample_rate=args.trace_sample_rate,
    )
    print(
        f"qps={stats['qps']:.0f} ok={stats['ok']} fail={stats['fail']} "
        f"avg={stats['latency_us_avg']:.0f}us p50={stats['latency_us_p50']:.0f}us "
        f"p99={stats['latency_us_p99']:.0f}us max={stats['latency_us_max']:.0f}us"
    )
    if args.fault_rate > 0 or args.fault_delay_ms > 0:
        return 0  # failures are the point of a brownout run
    return 0 if stats["fail"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
