"""Authenticator — per-connection credential fight (reference
src/brpc/authenticator.h: GenerateCredential on the client's first request
per connection, VerifyCredential once on the server side; impls like
policy/giano_authenticator).

The port's copy of the JAX package's ``rpc/auth.py``. The credential
rides the request meta's ``extra["auth"]``: tbus_std's JSON meta, or
baidu_std's authentication_data (RpcMeta field 7, which
``protocol/baidu_std.py`` maps to and from ``extra["auth"]``). On a
native-plane server ``TokenAuthenticator.native_tokens`` loads the C++
plane's constant-time token table, which checks baidu_std's field 7
without the interpreter (``transport/native_plane.py``); ``server_check``
runs on the Python route and pushes its verdict down to the connection.
Over HTTP the credential is the ``Authorization`` header: the channel's
http packer writes it, ``http_check`` verifies it.

Kept contract:
- the credential rides only the first request(s) on a connection (frames
  sent before the first response may all carry it — the reference's
  FightAuthentication lets concurrent first-writers race, one wins);
- the server verifies once and marks the connection authenticated;
  unauthenticated frames without a credential are rejected with ERPCAUTH.
"""

from __future__ import annotations

import hashlib
import hmac
import time
from typing import Optional


class Authenticator:
    """Subclass both sides (authenticator.h:30-52)."""

    def generate_credential(self) -> str:
        """Client: the auth string for a connection's first request."""
        raise NotImplementedError

    def verify_credential(self, auth_str: str, remote_side) -> bool:
        """Server: accept or reject a connection's credential."""
        raise NotImplementedError


class SharedSecretAuthenticator(Authenticator):
    """HMAC over a shared secret — a usable default (the reference ships
    ALL of its real authenticators as org-internal stubs).

    The credential is ``identity:timestamp:HMAC(secret, identity|timestamp)``
    and the server rejects timestamps outside ``freshness_window`` seconds,
    bounding replay to that window. Limitations (documented, not solved —
    match the reference's plaintext-credential posture): within the window
    an observer of one plaintext connection can replay the credential, and
    there is no channel binding; run over a trusted network or wrap the
    transport in TLS for anything stronger. ``freshness_window=0`` disables
    the check (accepts legacy two-part ``identity:digest`` credentials too).
    """

    def __init__(
        self, secret: str, identity: str = "client", freshness_window: float = 300.0
    ):
        self._secret = secret.encode()
        self.identity = identity
        self.freshness_window = freshness_window

    def _digest(self, identity: str, ts: str) -> str:
        msg = f"{identity}|{ts}".encode()
        return hmac.new(self._secret, msg, hashlib.sha256).hexdigest()

    def generate_credential(self) -> str:
        ts = str(int(time.time()))
        return f"{self.identity}:{ts}:{self._digest(self.identity, ts)}"

    def verify_credential(self, auth_str: str, remote_side) -> bool:
        parts = (auth_str or "").split(":")
        if len(parts) == 3:
            identity, ts, digest = parts
            # isdecimal (not isdigit: rejects superscripts etc.) + a length
            # bound so a crafted timestamp can't raise out of the fail-closed
            # path (int() conversion limits, float OverflowError)
            if not identity or not ts.isdecimal() or len(ts) > 20:
                return False
            if self.freshness_window and abs(time.time() - int(ts)) > self.freshness_window:
                return False
            return hmac.compare_digest(self._digest(identity, ts), digest)
        if len(parts) == 2 and not self.freshness_window:
            # legacy timestamp-less form, only when freshness is disabled
            identity, digest = parts
            want = hmac.new(self._secret, identity.encode(), hashlib.sha256)
            return hmac.compare_digest(want.hexdigest(), digest)
        return False


class TokenAuthenticator(Authenticator):
    """Static bearer-token table — the authenticator shape the native
    plane verifies WITHOUT the interpreter: ``native_tokens()`` hands the
    accepted credential strings to src/tbnet's constant-time token table
    (tb_server_set_auth_tokens), so an authenticated flood never leaves
    the C++ plane.  The Python side verifies the same table with
    constant-time compares, so both planes accept exactly the same
    credentials.  Rotate by listing old + new tokens during the window."""

    def __init__(self, tokens, identity: str = "client"):
        toks = [tokens] if isinstance(tokens, str) else list(tokens)
        if not toks:
            raise ValueError("TokenAuthenticator needs at least one token")
        self._tokens = [str(t) for t in toks]
        self.identity = identity

    def generate_credential(self) -> str:
        return self._tokens[0]

    def verify_credential(self, auth_str: str, remote_side) -> bool:
        cred = (auth_str or "").encode()
        ok = False
        for t in self._tokens:  # constant-time per token, no short-circuit
            ok |= hmac.compare_digest(t.encode(), cred)
        return ok

    def native_tokens(self):
        """The credential strings the C++ plane's constant-time table
        accepts (transport/native_plane._configure_auth)."""
        return list(self._tokens)


def _clear_on_revive(sock) -> None:
    # a revived Socket is a NEW connection: the server side has no
    # 'authenticated' mark, so the credential must be fought again
    sock.context.pop("auth_done", None)


def attach_credential(meta, sock, auth: Optional[Authenticator]) -> None:
    """Client side: add the credential while the connection is unproven."""
    if auth is None:
        return
    if not sock.context.get("auth_revive_hooked"):
        sock.context["auth_revive_hooked"] = True
        sock.on_revived.append(_clear_on_revive)
    if sock.context.get("auth_done"):
        return
    meta.extra["auth"] = auth.generate_credential()


def mark_authenticated(sock) -> None:
    sock.context["auth_done"] = True


def server_check(meta, sock, auth: Optional[Authenticator]) -> bool:
    """Server side: verify once per connection; True = let the request in."""
    if auth is None or sock.context.get("authenticated"):
        return True
    return _verify_connection(meta.extra.get("auth", ""), sock, auth)


def http_check(frame, auth: Optional[Authenticator]) -> bool:
    """Server side over HTTP: the credential is the request's
    ``Authorization`` header (the reference's VerifyHttpRequest,
    http_rpc_protocol.cpp), verified once per connection as
    ``server_check`` does. A frame with no connection is verified alone.

    Unlike the JAX package, whose gateway never asks the authenticator,
    the port holds every HTTP route but the builtin pages to the
    server's ``auth`` (builtin/pages.handle)."""
    if auth is None:
        return True
    cred = frame.headers.get("authorization", "")
    sock = getattr(frame, "sock", None)
    if sock is None:
        return auth.verify_credential(cred, None)
    if sock.context.get("authenticated"):
        return True
    return _verify_connection(cred, sock, auth)


def _verify_connection(cred: str, sock, auth: Authenticator) -> bool:
    if auth.verify_credential(cred, sock.remote):
        sock.context["authenticated"] = True
        # a NativeConnSock pushes the verdict down to the C++ conn so the
        # connection's later frames ride the native fast path
        notify = getattr(sock, "mark_native_authenticated", None)
        if notify is not None:
            notify()
        return True
    return False
