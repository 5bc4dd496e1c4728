"""session_data_and_thread_local — pooled per-connection and per-thread
user data (reference example/session_data_and_thread_local: a server whose
handlers read MySessionLocalData via cntl->session_local_data() and
MyThreadLocalData via brpc::thread_local_data(), both produced by
factories in ServerOptions and REUSED across connections/requests).

Demo: two clients connect in sequence; the second connection receives the
first one's recycled session object (same id, bumped use-count) — the
pooled-reuse contract. Thread data is created once per worker thread and
shared by every request that thread serves.
"""

import itertools
import threading

from incubator_brpc_tpu_torch.rpc import (
    Channel,
    ChannelOptions,
    Server,
    ServerOptions,
    thread_local_data,
)

_session_ids = itertools.count(1)
_thread_ids = itertools.count(1)


class SessionData:
    """Expensive per-session state (the reference example's
    MySessionLocalData)."""

    def __init__(self):
        self.sid = next(_session_ids)
        self.uses = 0


class SessionFactory:
    def create(self):
        return SessionData()

    def destroy(self, obj):
        print(f"session data #{obj.sid} destroyed after {obj.uses} uses")


class ThreadData:
    def __init__(self):
        self.tid = next(_thread_ids)
        self.requests = 0


def main() -> None:
    server = Server(
        ServerOptions(
            session_local_data_factory=SessionFactory(),
            reserved_session_local_data=1,
            thread_local_data_factory=ThreadData,
        )
    )

    def whoami(cntl, request: bytes) -> bytes:
        sd = cntl.session_local_data()
        td = thread_local_data()
        sd.uses += 1
        td.requests += 1
        return (
            f"session={sd.sid} session_uses={sd.uses} "
            f"thread={td.tid} thread_requests={td.requests} "
            f"worker={threading.current_thread().name}"
        ).encode()

    server.add_service("Session", {"WhoAmI": whoami})
    assert server.start(0)

    sessions_seen = []
    for conn in range(2):  # two connections, one after the other
        ch = Channel()
        # short connections: each client call cycle gets its OWN
        # connection, so the second loop demonstrates pool reuse
        assert ch.init(
            f"127.0.0.1:{server.port}",
            options=ChannelOptions(connection_type="short", timeout_ms=10000),
        )
        cntl = ch.call_method("Session", "WhoAmI", b"")
        assert cntl.ok(), cntl.error_text
        print(f"conn {conn}: {cntl.response_payload.decode()}")
        sessions_seen.append(cntl.response_payload.split(b" ")[0])

    server.stop()
    server.join(timeout=10)
    print(f"pooled sessions observed: {sessions_seen}")


if __name__ == "__main__":
    main()
