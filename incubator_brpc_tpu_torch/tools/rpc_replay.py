"""rpc_replay — re-issue dumped requests against a server (reference
tools/rpc_replay: reads rpc_dump sample files and replays them through a
Channel at a chosen concurrency).

Usage:
    python -m incubator_brpc_tpu_torch.tools.rpc_replay --dir ./rpc_dump --server 127.0.0.1:8000 \
        --threads 4 --times 1

The port's copy of the JAX package's ``tools/rpc_replay.py``, reading dump
files with the port's ``rpc/dump.load_dump_file`` (either package's files).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import threading


def load_requests(path_or_dir: str):
    """All (meta, payload, attachment) samples under a file or directory."""
    from incubator_brpc_tpu_torch.rpc.dump import load_dump_file

    if os.path.isdir(path_or_dir):
        paths = sorted(glob.glob(os.path.join(path_or_dir, "requests.*")))
    else:
        paths = [path_or_dir]
    out = []
    for p in paths:
        out.extend(load_dump_file(p))
    return out


def run_replay(
    requests,
    server: str,
    threads: int = 1,
    times: int = 1,
    timeout_ms: float = 1000,
) -> dict:
    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions

    ch = Channel()
    if not ch.init(server, options=ChannelOptions(timeout_ms=timeout_ms)):
        raise SystemExit(f"cannot init channel to {server}")
    work = list(requests) * times
    counts = {"ok": 0, "fail": 0}
    lock = threading.Lock()
    idx = {"next": 0}

    def worker():
        ok = fail = 0
        while True:
            with lock:
                i = idx["next"]
                if i >= len(work):
                    break
                idx["next"] = i + 1
            meta, payload, attachment = work[i]
            cntl = ch.call_method(
                meta.service, meta.method, payload, attachment=attachment
            )
            if cntl.ok():
                ok += 1
            else:
                fail += 1
        with lock:
            counts["ok"] += ok
            counts["fail"] += fail

    ts = [threading.Thread(target=worker) for _ in range(max(1, threads))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return dict(counts, total=len(work))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True, help="dump file or directory")
    p.add_argument("--server", required=True, help="ip:port or naming url")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--times", type=int, default=1, help="replay each sample N times")
    p.add_argument("--timeout-ms", type=float, default=1000)
    args = p.parse_args(argv)

    requests = load_requests(args.dir)
    if not requests:
        print(f"no samples under {args.dir}", file=sys.stderr)
        return 1
    stats = run_replay(
        requests,
        args.server,
        threads=args.threads,
        times=args.times,
        timeout_ms=args.timeout_ms,
    )
    print(f"replayed={stats['total']} ok={stats['ok']} fail={stats['fail']}")
    return 0 if stats["fail"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
