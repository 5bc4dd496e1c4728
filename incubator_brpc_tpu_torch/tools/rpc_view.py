"""rpc_view — inspect a server or rpc_dump samples (reference
tools/rpc_view: a proxy server that forwards any path to the target's
builtin portal and annotates the rendering, rpc_view.cpp:23-60; plus the
dump-file printer role of rpc_replay's sibling tooling).

Two modes:

  Proxy a live server's portal (the reference tool's shape):
    python -m incubator_brpc_tpu_torch.tools.rpc_view --serve 8888 --target 127.0.0.1:8000
    # then browse http://127.0.0.1:8888/status /vars /rpcz /protobufs ...

  Print rpc_dump sample files:
    python -m incubator_brpc_tpu_torch.tools.rpc_view ./rpc_dump/requests.1234.0000
    python -m incubator_brpc_tpu_torch.tools.rpc_view --service users --method get --json dump.0000

  Scrape /brpc_metrics and pretty-print the delta between two scrapes
  (the poor man's rpc_press dashboard — counters as rates, gauges and
  summary quantiles as current values):
    python -m incubator_brpc_tpu_torch.tools.rpc_view --metrics --target 127.0.0.1:8000
    python -m incubator_brpc_tpu_torch.tools.rpc_view --metrics --target 127.0.0.1:8000 \
        --interval 5 --prefix method_

  Scrape /rpcz?json=1 — recent sampled spans, or one assembled trace
  tree (the scrape-side twin of --metrics for the tracing plane):
    python -m incubator_brpc_tpu_torch.tools.rpc_view --rpcz --target 127.0.0.1:8000
    python -m incubator_brpc_tpu_torch.tools.rpc_view --rpcz --target 127.0.0.1:8000 \
        --trace-id 1f00dbeef --min-latency-us 500 --error-only

  Assemble ONE distributed trace across a fleet (pulls
  /rpcz?trace_id=&json=1 from every node, merges by span id, renders
  the cross-process parent→child tree):
    python -m incubator_brpc_tpu_torch.tools.rpc_view --trace 1f00dbeef \
        --targets 10.0.0.1:8000,10.0.0.2:8000

The port's copy of the JAX package's ``tools/rpc_view.py``: the same
flags, functions and printed lines, on the port's ``builtin/rpcz`` and
``rpc/dump``; either package's servers and dump files can be viewed.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?) (-?\d+(?:\.\d+)?"
    r"(?:[eE][+-]?\d+)?|[+-]Inf|NaN)$"
)


def parse_exposition(text: str):
    """Prometheus text exposition -> ({series_key: float}, {name: type}).
    A series key is the metric name plus its label set verbatim
    (``m{quantile="0.99"}``); types come from the ``# TYPE`` comments."""
    values = {}
    types = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) == 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        values[m.group(1)] = float(
            m.group(2).replace("Inf", "inf").replace("NaN", "nan")
        )
    return values, types


def _series_base(key: str) -> str:
    return key.partition("{")[0]


def _is_counterish(key: str, types: dict) -> bool:
    """counter samples and summary _sum/_count accumulate: show as rates."""
    base = _series_base(key)
    if types.get(base) == "counter":
        return True
    for suffix in ("_sum", "_count"):
        if base.endswith(suffix) and types.get(base[: -len(suffix)]) == "summary":
            return True
    return False


def metrics_delta_lines(before, after, types, seconds: float):
    """Human-readable rows for every series whose value changed between
    two scrapes (counter-ish series get a +delta and a per-second rate),
    plus quantile lines of any summary that saw traffic."""
    out = []
    changed_summaries = set()
    for key in sorted(after):
        base = _series_base(key)
        if types.get(base) == "summary":
            continue  # quantile lines: shown with their summary below
        old = before.get(key)
        new = after[key]
        if old is not None and old == new:
            continue
        if _is_counterish(key, types):
            delta = new - (old or 0.0)
            rate = delta / seconds if seconds > 0 else 0.0
            out.append(
                f"{key} {_num(old)} -> {_num(new)}  (+{_num(delta)}, "
                f"{rate:.1f}/s)"
            )
            if base.endswith("_count"):
                changed_summaries.add(base[: -len("_count")])
        else:
            out.append(f"{key} {_num(old)} -> {_num(new)}")
    for key in sorted(after):
        base = _series_base(key)
        if "{" in key and base in changed_summaries:
            out.append(f"{key} {_num(after[key])}")
    return out


def _num(v) -> str:
    if v is None:
        return "-"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))  # full precision: %g would round big counters
    return f"{v:g}"


def scrape_metrics(target: str, prefix: str = ""):
    """One GET /brpc_metrics against host:port -> (values, types)."""
    from incubator_brpc_tpu_torch.protocol.http import http_call

    host, _, port = target.rpartition(":")
    path = "/brpc_metrics" + (f"?prefix={prefix}" if prefix else "")
    status, _, body = http_call(host, int(port), path, timeout=15)
    if status != 200:
        raise OSError(f"GET {path} -> {status}")
    return parse_exposition(body.decode())


def metrics_mode(target: str, interval: float, prefix: str = "") -> int:
    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        print(f"bad --target {target!r} (want host:port)", file=sys.stderr)
        return 2
    try:
        before, types = scrape_metrics(target, prefix)
    except OSError as e:
        print(f"rpc_view: target {target} unreachable: {e}", file=sys.stderr)
        return 1
    if interval <= 0:
        # single scrape: dump current values
        for key in sorted(before):
            print(f"{key} {_num(before[key])}")
        print(f"# {len(before)} series from {target}")
        return 0
    t0 = time.monotonic()
    time.sleep(interval)
    try:
        after, types2 = scrape_metrics(target, prefix)
    except OSError as e:
        print(
            f"rpc_view: target {target} unreachable on second scrape: {e}",
            file=sys.stderr,
        )
        return 1
    # rates use the MEASURED window: the second scrape itself can take
    # long enough (loaded server, big percentile reservoirs) to skew
    # nominal-interval rates exactly when an operator is reading them
    elapsed = time.monotonic() - t0
    types.update(types2)
    lines = metrics_delta_lines(before, after, types, elapsed)
    print(f"# /brpc_metrics delta over {elapsed:.1f}s — {target}")
    for line in lines:
        print(line)
    print(f"# {len(after)} series, {len(lines)} rows changed")
    return 0


_LINK_SERIES_RE = re.compile(r"^device_link_(\d+)_([a-z0-9_]+?)(\{.*\})?$")


def links_table(values: dict) -> list:
    """Rows for every device link in one /brpc_metrics scrape: the
    per-link rtt/bytes-per-second recorders grouped by link id —
    the scrape-side rendering of ``DeviceLinkMap.link_profile()``, so an
    operator can see the same speeds the topology-aware session
    scheduler orders by."""
    links: dict = {}
    for key, val in values.items():
        m = _LINK_SERIES_RE.match(key)
        if m is None:
            continue
        link_id, field, label = int(m.group(1)), m.group(2), m.group(3)
        row = links.setdefault(link_id, {})
        if field == "step_rtt_us" and label == '{quantile="0.99"}':
            row["rtt_p99_us"] = val
        elif field == "step_rtt_us_sum":
            row["rtt_sum"] = val
        elif field == "step_rtt_us_count":
            row["steps"] = val
        elif field == "out_bytes_second" and not label:
            row["out_bps"] = val
        elif field == "in_bytes_second" and not label:
            row["in_bps"] = val
    out = []
    for link_id in sorted(links):
        row = links[link_id]
        steps = row.get("steps", 0.0)
        rtt = (row.get("rtt_sum", 0.0) / steps) if steps else 0.0
        out_bps = row.get("out_bps", 0.0)
        in_bps = row.get("in_bps", 0.0)
        out.append(
            f"device_link_{link_id}: rtt={rtt:.1f}us "
            f"p99={row.get('rtt_p99_us', 0.0):.1f}us "
            f"steps={int(steps)} out={out_bps:.0f}B/s in={in_bps:.0f}B/s "
            f"gbps={(out_bps + in_bps) / 1e9:.6f}"
        )
    return out


def links_mode(target: str) -> int:
    """Print the target's per-device-link telemetry (rtt + bytes/s per
    direction + GB/s) — the measured speeds the scheduler uses."""
    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        print(f"bad --target {target!r} (want host:port)", file=sys.stderr)
        return 2
    try:
        values, _types = scrape_metrics(target, prefix="device_link_")
    except OSError as e:
        print(f"rpc_view: target {target} unreachable: {e}", file=sys.stderr)
        return 1
    lines = links_table(values)
    print(f"# device links of {target} — {len(lines)} live")
    for line in lines:
        print(line)
    if not lines:
        print("# (no per-link series: no live device links, or all retired)")
    return 0


def scrape_rpcz(
    target: str,
    trace_id: str = "",
    min_latency_us: float = None,
    error_only: bool = False,
):
    """GET /rpcz?json=1 against host:port -> list of Span objects."""
    from urllib.parse import urlencode

    from incubator_brpc_tpu_torch.builtin.rpcz import span_from_dict
    from incubator_brpc_tpu_torch.protocol.http import http_call

    host, _, port = target.rpartition(":")
    query = [("json", "1")]
    if trace_id:
        query.append(("trace_id", trace_id))
    if min_latency_us is not None:
        # urlencode, not f-strings: %g renders 1e6 as "1e+06" and a bare
        # '+' decodes to a space on the server side
        query.append(("min_latency_us", f"{min_latency_us:g}"))
    if error_only:
        query.append(("error_only", "1"))
    path = "/rpcz?" + urlencode(query)
    status, _, body = http_call(host, int(port), path, timeout=15)
    if status != 200:
        raise OSError(f"GET {path} -> {status}: {body[:200].decode(errors='replace')}")
    return [
        sp
        for sp in (span_from_dict(d) for d in json.loads(body.decode()))
        if sp is not None
    ]


def rpcz_mode(
    target: str,
    trace_id: str = "",
    min_latency_us: float = None,
    error_only: bool = False,
) -> int:
    """Print a target's recent sampled spans (or one assembled trace as
    an indented parent→child tree when --trace-id is given).  A trace
    carrying overlap-session chunk spans (``chunk=j/C`` annotations)
    additionally gets the overlap report — per-chunk ack-vs-next-compute
    timing with an OVERLAPPED/SERIALIZED verdict, so a schedule that
    regressed to serialization is visible at a glance."""
    from incubator_brpc_tpu_torch.builtin.rpcz import (
        overlap_report,
        render_trace_tree,
        span_line,
    )

    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        print(f"bad --target {target!r} (want host:port)", file=sys.stderr)
        return 2
    try:
        spans = scrape_rpcz(target, trace_id, min_latency_us, error_only)
    except (OSError, ValueError) as e:
        # carries the server's reason too (e.g. the 503 "rpcz is off" body)
        print(f"rpc_view: rpcz scrape of {target} failed: {e}", file=sys.stderr)
        return 1
    if trace_id and min_latency_us is None and not error_only:
        lines = render_trace_tree(spans) + overlap_report(spans)
    else:
        lines = [span_line(sp) for sp in spans]
    print(f"# /rpcz of {target} — {len(spans)} spans")
    for line in lines:
        print(line)
    return 0


def fleet_trace_mode(targets: list, trace_id: str) -> int:
    """Assemble ONE distributed trace from many processes: pull
    ``/rpcz?trace_id=<id>&json=1`` from every target and render the
    merged cross-process parent→child tree (plus the overlap report when
    the trace carries collective chunk spans).

    Span identity is the 63-bit span id, so parent links stitch across
    process boundaries exactly; clock skew between nodes follows the
    overlap verdict's discipline — parent→child EDGES come from ids,
    never clocks, and start-time ordering among siblings from different
    nodes is best-effort (each span keeps its producer's wall clock).
    Spans are tagged ``node=<target>`` so the origin of every line is
    visible in the merged rendering."""
    from incubator_brpc_tpu_torch.builtin.rpcz import (
        overlap_report,
        render_trace_tree,
    )

    merged = {}
    counts = []
    failures = 0
    for target in targets:
        host, _, port = target.rpartition(":")
        if not host or not port.isdigit():
            print(f"bad target {target!r} (want host:port)", file=sys.stderr)
            return 2
        try:
            spans = scrape_rpcz(target, trace_id)
        except (OSError, ValueError) as e:
            print(
                f"rpc_view: rpcz scrape of {target} failed: {e}",
                file=sys.stderr,
            )
            failures += 1
            counts.append((target, -1))
            continue
        counts.append((target, len(spans)))
        for sp in spans:
            sp.annotations.append((0.0, f"node={target}"))
            # first pull wins on a duplicate span id (a node scraped
            # twice, or a persisted+live copy): the tree must not show
            # the same span as two children
            merged.setdefault(sp.span_id, sp)
    spans = sorted(merged.values(), key=lambda s: s.start_real_us)
    print(
        f"# trace {trace_id} across {len(targets)} nodes — "
        f"{len(spans)} spans"
    )
    for target, n in counts:
        print(f"#   {target}: " + ("unreachable" if n < 0 else f"{n} spans"))
    for line in render_trace_tree(spans) + overlap_report(spans):
        print(line)
    if failures == len(targets):
        return 1
    return 0


def make_proxy_server(target: str):
    """Build (but do not start) the rpc_view front server: every path
    relays to the target's portal, renderings are tagged with the origin
    (rpc_view.cpp:52-60). Returns the Server, or None on a bad target."""
    from incubator_brpc_tpu_torch.protocol.http import http_call
    from incubator_brpc_tpu_torch.rpc import Server, ServerOptions

    host, _, tport = target.rpartition(":")
    if not host or not tport.isdigit():
        return None

    def relay(frame):
        from urllib.parse import urlencode

        path = frame.path
        if frame.query:
            # values arrived URL-decoded (parse_qsl): re-encode, or spaces
            # and '&'/'=' inside values would corrupt the target's request
            path = f"{path}?{urlencode(frame.query)}"
        try:
            status, headers, body = http_call(
                host, int(tport), path, method=frame.method,
                body=frame.body if isinstance(frame.body, bytes) else b"",
                timeout=15,
            )
        except OSError as e:
            return 502, "text/plain", (
                f"rpc_view: target {target} unreachable: {e}\n".encode()
            )
        ctype = headers.get("content-type", "text/plain")
        # visually tag HUMAN renderings with the target (rpc_view.cpp:52-60)
        # — never binary or machine-parsed payloads (/dir files, pprof
        # folded output), which must relay byte-identical
        if "html" in ctype and b"</body>" in body:
            tag = f"<hr><i>rpc_view of {target}</i>".encode()
            body = body.replace(b"</body>", tag + b"</body>", 1)
        elif ctype.startswith("text/plain") and not path.startswith("/pprof"):
            body = f"# rpc_view of {target}{path}\n".encode() + body
        return status, ctype, body

    # no builtin pages on the front: the whole point is viewing the
    # TARGET's portal, so every path — /status, /vars, /rpcz — relays
    srv = Server(ServerOptions(has_builtin_services=False))
    srv.add_http_handler("/", relay)  # prefix: every path relays
    return srv


def serve_proxy(port: int, target: str) -> int:
    srv = make_proxy_server(target)
    if srv is None:
        print(f"bad --target {target!r} (want host:port)", file=sys.stderr)
        return 2
    if not srv.start(port):
        print(f"cannot listen on {port}", file=sys.stderr)
        return 1
    print(f"rpc_view of {target} on http://127.0.0.1:{srv.port}/  (Ctrl-C stops)")
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
    return 0


def print_dumps(args) -> int:
    from incubator_brpc_tpu_torch.rpc.dump import load_dump_file

    n = shown = 0
    for path in args.paths:
        for meta, payload, attachment in load_dump_file(path):
            n += 1
            if args.service and meta.service != args.service:
                continue
            if args.method and meta.method != args.method:
                continue
            shown += 1
            if args.json:
                print(
                    json.dumps(
                        {
                            "service": meta.service,
                            "method": meta.method,
                            "payload_len": len(payload),
                            "attachment_len": len(attachment),
                            "compress": meta.compress,
                            "log_id": meta.log_id,
                            "payload_head": payload[: args.max_payload].hex(),
                        }
                    )
                )
            else:
                preview = payload[: args.max_payload]
                print(
                    f"[{shown - 1}] {meta.service}.{meta.method} "
                    f"payload={len(payload)}B attachment={len(attachment)}B "
                    f"compress={meta.compress or '-'} log_id={meta.log_id} "
                    f"| {preview!r}"
                )
    print(f"{shown}/{n} samples", file=sys.stderr if args.json else sys.stdout)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("paths", nargs="*", help="dump files (dump mode)")
    p.add_argument("--max-payload", type=int, default=64, help="bytes shown")
    p.add_argument("--service", help="only samples of this service")
    p.add_argument("--method", help="only samples of this method")
    p.add_argument("--json", action="store_true", help="one JSON line per sample")
    p.add_argument("--serve", type=int, help="proxy mode: listen on this port")
    p.add_argument(
        "--target", help="proxy/metrics mode: host:port of the server"
    )
    p.add_argument(
        "--metrics",
        action="store_true",
        help="scrape /brpc_metrics from --target and print the delta "
        "between two scrapes (--interval apart; 0 = one scrape)",
    )
    p.add_argument(
        "--interval",
        type=float,
        default=1.0,
        help="metrics mode: seconds between the two scrapes",
    )
    p.add_argument(
        "--prefix", default="", help="metrics mode: only metrics with this prefix"
    )
    p.add_argument(
        "--rpcz",
        action="store_true",
        help="scrape /rpcz?json=1 from --target and print recent spans "
        "(or one trace tree with --trace-id)",
    )
    p.add_argument(
        "--links",
        action="store_true",
        help="scrape --target's per-device-link telemetry (rtt + bytes/s "
        "+ GB/s per link — what the topology-aware scheduler orders by)",
    )
    p.add_argument(
        "--trace-id",
        default="",
        help="rpcz mode: assemble and print this trace (hex) as a tree",
    )
    p.add_argument(
        "--trace",
        default="",
        help="fleet mode: the (hex) trace id to assemble across --targets",
    )
    p.add_argument(
        "--targets",
        default="",
        help="fleet trace assembly: comma-separated host:port list — pull "
        "/rpcz?trace_id=&json=1 from every node and render the merged "
        "cross-process tree (rpc_view --trace <id> --targets a:p,b:p)",
    )
    p.add_argument(
        "--min-latency-us",
        type=float,
        default=None,
        help="rpcz mode: only spans at least this slow (latency-ordered)",
    )
    p.add_argument(
        "--error-only",
        action="store_true",
        help="rpcz mode: only spans that ended in an error",
    )
    args = p.parse_args(argv)

    if args.targets:
        trace = args.trace or args.trace_id
        if not trace:
            p.error("--targets requires --trace <hex trace id>")
        return fleet_trace_mode(
            [t for t in args.targets.split(",") if t], trace
        )
    if args.links:
        if not args.target:
            p.error("--links requires --target host:port")
        return links_mode(args.target)
    if args.rpcz:
        if not args.target:
            p.error("--rpcz requires --target host:port")
        return rpcz_mode(
            args.target, args.trace_id, args.min_latency_us, args.error_only
        )
    if args.metrics:
        if not args.target:
            p.error("--metrics requires --target host:port")
        return metrics_mode(args.target, args.interval, args.prefix)
    if args.serve is not None:
        if not args.target:
            p.error("--serve requires --target host:port")
        return serve_proxy(args.serve, args.target)
    if not args.paths:
        p.error("give dump files, or --serve/--metrics with --target")
    return print_dumps(args)


if __name__ == "__main__":
    raise SystemExit(main())
