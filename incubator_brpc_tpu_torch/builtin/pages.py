"""Builtin HTTP portal pages and the request router (reference
src/brpc/builtin/*_service.cpp, wired into every server by
Server::AddBuiltinServices, server.cpp:433).

Each page is ``fn(server, frame) -> (status, content_type, body_bytes)``,
optionally with a fourth element, a ``{header: value}`` dict of extra
response headers. User handlers registered with
``Server.add_http_handler`` are consulted after the builtin table (the
reference forbids shadowing builtins too).

The port's copy of the JAX package's ``builtin/pages.py``, holding the
routing of ``handle`` and two pages: ``/health`` (503 while the server
stops or drains in lame duck) and ``/quitquitquit`` (the lame duck's
remote trigger, behind the ``enable_quitquitquit`` flag). Every other
builtin path of the JAX package (``UNPORTED``, and the ``/vars/``,
``/flags/``, ``/dir/`` and ``/protobufs/`` prefixes) answers 501 naming
ROADMAP A12, which brings those pages: never a 404, and never another page.
On a server with ``auth``, the routes past the builtin pages answer 401
unless the connection's ``Authorization`` header verified
(``rpc/auth.http_check``); the JAX package's gateway does not ask.
"""

from __future__ import annotations

from typing import Dict, Tuple

from incubator_brpc_tpu_torch.rpc.auth import http_check
from incubator_brpc_tpu_torch.utils.flags import get_flag

Resp = Tuple[int, str, bytes]


def _health(server, frame) -> Resp:
    # health_service.cpp: plain OK unless the server is stopping — or
    # lame-duck draining (the LB/naming side's signal to stop picking
    # this node while its in-flight work finishes)
    if server is not None and getattr(server, "lame_duck", False):
        return 503, "text/plain", b"lame-duck"
    if server is not None and not server.running:
        return 503, "text/plain", b"stopping"
    return 200, "text/plain", b"OK"


def _quitquitquit(server, frame) -> Resp:
    """The reference's /quitquitquit graceful-quit trigger: flip this
    server into lame duck (stop accepting, fail /health, drain in-flight
    RPCs and open sessions, then stop). ``?grace_s=`` overrides the
    ``lame_duck_grace_s`` flag for this drain.

    Gated behind the reloadable ``enable_quitquitquit`` flag (default
    OFF — an unauthenticated remote stop must be opt-in)."""
    if not get_flag("enable_quitquitquit"):
        return (
            403,
            "text/plain",
            b"quitquitquit is off - set flag enable_quitquitquit "
            b"(default off: this endpoint stops the server)\n",
        )
    if server is None:
        return 400, "text/plain", b"no owning server\n"
    grace = None
    if "grace_s" in frame.query:
        try:
            grace = float(frame.query["grace_s"])
        except ValueError:
            return 400, "text/plain", b"bad grace_s\n"
        if grace <= 0:
            return 400, "text/plain", b"grace_s must be > 0\n"
    if server.enter_lame_duck(grace) is None and not server.lame_duck:
        return 409, "text/plain", b"server is not running\n"
    return 200, "text/plain", b"lame-duck drain started\n"


# the JAX package's other builtin pages (its _PAGES), each answered 501
UNPORTED = (
    "/", "/index", "/version", "/vars", "/vars.json", "/vars/series.json",
    "/brpc_metrics", "/status", "/flags", "/circuit_breakers", "/rpcz",
    "/connections", "/sockets", "/fibers", "/ids", "/hotspots",
    "/hotspots/contention", "/hotspots/heap", "/pprof/profile",
    "/pprof/contention", "/pprof/heap", "/protobufs", "/dir", "/threads",
    "/vlog",
)


def _unported(server, frame) -> Resp:
    return (
        501,
        "text/plain",
        f"builtin page {frame.path} is not in the port yet (ROADMAP A12)\n".encode(),
    )


_PAGES: Dict[str, object] = {
    "/health": _health,
    "/quitquitquit": _quitquitquit,
    **{path: _unported for path in UNPORTED},
}


def handle(server, frame) -> Resp:
    """Dispatch: exact builtin page, prefixed builtin (/vars/x, /flags/x),
    then the owning server's registered http handlers, restful mappings
    and the /<service>/<method> gateway."""
    builtins_on = server is None or getattr(
        server.options, "has_builtin_services", True
    )
    fn = _PAGES.get(frame.path) if builtins_on else None
    if fn is None and builtins_on:
        for prefix in ("/vars/", "/flags/", "/dir/", "/protobufs/"):
            if frame.path.startswith(prefix):
                fn = _PAGES[prefix[:-1]]
                break
    if fn is not None:
        return fn(server, frame)
    if server is not None:
        # every route past the builtin pages answers only a verified
        # connection when the server has an authenticator, as its binary
        # routes do (builtin pages pass, as in the reference)
        if not http_check(frame, server.options.auth):
            return 401, "text/plain", b"authentication failed\n"
        handler = server.find_http_handler(frame.path)
        if handler is not None:
            return handler(frame)
        # restful mappings route custom paths into the method map
        # (ServiceOptions.restful_mappings, restful.cpp)
        restful = server.find_restful(frame.path)
        if restful is not None:
            return server.invoke_for_http(
                restful[0], restful[1], frame.body,
                sock=getattr(frame, "sock", None),
            )
        # http→rpc gateway: /<service>/<method> reaches the same method map
        # as the binary protocol (http_rpc_protocol.cpp's pb-over-http)
        parts = frame.path.strip("/").split("/")
        if len(parts) == 2 and server.has_method(f"{parts[0]}.{parts[1]}"):
            return server.invoke_for_http(
                parts[0], parts[1], frame.body, sock=getattr(frame, "sock", None)
            )
    return 404, "text/plain", f"no handler for {frame.path}\n".encode()
