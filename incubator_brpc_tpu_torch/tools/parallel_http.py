"""parallel_http — fetch many URLs concurrently through the HTTP channel
client (reference tools/parallel_http/parallel_http.cpp: "access many
http servers in parallel, much faster than curl called in batch").

Usage:
    python -m incubator_brpc_tpu_torch.tools.parallel_http --url-file urls.txt --threads 8
    echo http://127.0.0.1:8000/health | python -m incubator_brpc_tpu_torch.tools.parallel_http

Each output line: ``<status-or-error> <bytes> <ms> <url>``.

The port's copy of the JAX package's ``tools/parallel_http.py``, over the
port's HTTP channel.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from urllib.parse import urlsplit


def _parse_url(url: str):
    """(host, port, path) from an http:// url."""
    parts = urlsplit(url if "//" in url else f"http://{url}")
    if parts.scheme not in ("http", ""):
        raise ValueError(f"only http urls supported: {url}")
    host = parts.hostname or ""
    port = parts.port or 80
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    return host, port, path


def fetch_all(
    urls, threads: int = 8, timeout_ms: float = 1000, max_retry: int = 3
):
    """Fetch every url over shared per-endpoint channels; returns results
    in input order: (url, status_or_None, body_len, elapsed_ms, error)."""
    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions

    channels = {}
    chan_lock = threading.Lock()

    def channel_for(host: str, port: int):
        key = (host, port)
        with chan_lock:
            ch = channels.get(key)
            if ch is None:
                ch = Channel()
                ok = ch.init(
                    f"{host}:{port}",
                    options=ChannelOptions(
                        protocol="http",
                        timeout_ms=timeout_ms,
                        max_retry=max_retry,
                    ),
                )
                channels[key] = ch if ok else None
            return channels[key]

    results = [None] * len(urls)
    cursor = [0]
    cursor_lock = threading.Lock()

    def worker():
        while True:
            with cursor_lock:
                i = cursor[0]
                if i >= len(urls):
                    return
                cursor[0] += 1
            url = urls[i]
            t0 = time.monotonic()
            try:
                from incubator_brpc_tpu_torch.rpc import Controller

                host, port, path = _parse_url(url)
                ch = channel_for(host, port)
                if ch is None:
                    raise ConnectionError("channel init failed")
                cntl = Controller(timeout_ms=timeout_ms)
                cntl.request_extra = {
                    "http_path": path, "http_method": "GET"
                }
                cntl = ch.call_method("", "", b"", cntl=cntl)
                ms = (time.monotonic() - t0) * 1e3
                if cntl.ok():
                    results[i] = (
                        url, cntl.http_status,
                        len(cntl.response_payload), ms, "",
                    )
                else:
                    results[i] = (
                        url, getattr(cntl, "http_status", None), 0, ms,
                        cntl.error_text,
                    )
            except (OSError, ValueError, ConnectionError) as e:
                ms = (time.monotonic() - t0) * 1e3
                results[i] = (url, None, 0, ms, str(e))

    ts = [threading.Thread(target=worker) for _ in range(max(1, threads))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--url-file", default="", help="file of urls; default stdin")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--timeout-ms", type=float, default=1000)
    ap.add_argument("--max-retry", type=int, default=3)
    args = ap.parse_args()
    if args.url_file:
        with open(args.url_file) as f:
            urls = [ln.strip() for ln in f if ln.strip()]
    else:
        urls = [ln.strip() for ln in sys.stdin if ln.strip()]
    if not urls:
        print("no urls", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    results = fetch_all(
        urls, threads=args.threads, timeout_ms=args.timeout_ms,
        max_retry=args.max_retry,
    )
    nok = 0
    for url, status, nbytes, ms, err in results:
        if err:
            print(f"ERR({err[:40]}) {nbytes} {ms:.1f} {url}")
        else:
            nok += 1
            print(f"{status} {nbytes} {ms:.1f} {url}")
    dt = time.monotonic() - t0
    print(
        f"# {nok}/{len(urls)} ok in {dt*1e3:.0f} ms "
        f"({len(urls)/max(dt,1e-9):.0f} urls/s)",
        file=sys.stderr,
    )
    return 0 if nok == len(urls) else 2


if __name__ == "__main__":
    sys.exit(main())
