"""Pipelined collective sessions: pmean as one registered method on the
collective method plane — the counterpart of
``incubator_brpc_tpu/parallel/mc_collective.py`` (:135-240).

The session machinery lives in ``parallel/mc_dispatch.py`` and is
kernel-agnostic. pmean survives as one method on it: the kernel below
reinterprets the row bytes as float32, averages over the party axis (the
exact f32 mean, carried by PyTorch: a party-ordered sum and a division),
and writes the bytes back. It is width-independent (geometry is the
DeviceMethod's), so one source mints a DeviceMethod per requested width
via the resolver, with the int8/int4 variants of ``parallel/quantized.py``
(K2) attached.

The RPC half is the JAX module's (:241-423): a session is proposed as a
plain RPC to every server (``_tpu_transport.collective``, registered by
``ServerOptions(enable_collective_service=True)``): {parties, your party
index, steps, width, seed, and the session id that keys its process group
across processes}. Each server answers an accept pre-ack first (nothing
runs), then runs its party's pmean chain and answers with its row's
checksum; the proposer runs its own party in between. The session spans
the JAX module opens wait for the port's rpcz (ROADMAP A12).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import List, Optional, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder
from incubator_brpc_tpu_torch.parallel import mc_dispatch
from incubator_brpc_tpu_torch.parallel import quantized as _quantized
from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod
from incubator_brpc_tpu_torch.utils.device import DeviceLike
from incubator_brpc_tpu_torch.utils.status import ErrorCode, berror

COLLECTIVE_METHOD = "collective"

# How long propose_collective watches freshly-dispatched RUN proposals for
# an instant bounce (admission ELIMIT from an overlapping session, a server
# mid-stop) before entering its own session; the accept pre-ack already
# covers validation rejections, so this only spans a local round trip.
_REJECT_WATCH_S = 0.05

# session-level observability: every run_collective_session counts here
collective_sessions = Adder(name="mc_collective_sessions")
collective_steps = Adder(name="mc_collective_steps")
collective_errors = Adder(name="mc_collective_errors")
collective_session_us = LatencyRecorder(name="mc_collective_session_us")

PMEAN_SERVICE = "_collective"
PMEAN_METHOD = "pmean"


def _pmean_bytes_kernel(data, n, axis):
    f = data.view(torch.float32)
    m = axis.psum(f) / torch.full_like(f, float(axis.size))
    return m.view(torch.uint8), n


_pmean_dms: dict = {}
_pmean_lock = threading.Lock()


def _pmean_dm(width_bytes: int):
    with _pmean_lock:
        dm = _pmean_dms.get(width_bytes)
        if dm is None:
            # chunkable: pmean is elementwise along the width (psum of a
            # slice IS the slice of the psum) and passes n through — the
            # chunk-safety contract verbatim
            dm = DeviceMethod(
                _pmean_bytes_kernel, width=width_bytes, chunkable=True
            )
            # the quantize= session knob resolves through these variants
            # (block-aligned widths only; others reject before any step)
            _quantized.attach_pmean_variants(dm, width_bytes)
            _pmean_dms[width_bytes] = dm
        return dm


def _resolve_pmean(service: str, method: str, width):
    """mc_dispatch method resolver: mints the pmean DeviceMethod for any
    float32-aligned width, so sessions of arbitrary geometry resolve the
    same fingerprint everywhere without a registration."""
    if (
        service == PMEAN_SERVICE
        and method == PMEAN_METHOD
        and isinstance(width, int)
        and width > 0
        and width % 4 == 0
    ):
        return _pmean_dm(width)
    return None


def _install_resolver() -> None:
    mc_dispatch.register_method_resolver(_resolve_pmean)


_install_resolver()


def run_collective_session(
    party_ids: List[int],
    own_index: int,
    steps: int,
    width: int,
    seed: int,
    device: DeviceLike = None,
    session_id: Optional[str] = None,
) -> Tuple[np.ndarray, float]:
    """Run a pmean session of ``width`` float32 values per party; returns
    (party ``own_index``'s final row, elapsed seconds). One step pulls
    every party to the global mean, the invariant each party checks.
    Across processes every party passes the same ``session_id``."""
    dm = _pmean_dm(4 * width)
    # every party's operand derives from the seed, so each side stages the
    # rows it holds without communication
    operands = [
        _party_operand(seed, i, width).tobytes()
        for i in range(len(party_ids))
    ]
    own_row, own_n, elapsed = mc_dispatch.run_dispatch_session(
        party_ids, own_index, dm, operands, steps,
        service=PMEAN_SERVICE, method=PMEAN_METHOD, device=device,
        session_id=session_id,
    )
    own = np.frombuffer(
        bytes(np.asarray(own_row[:own_n], dtype=np.uint8)), dtype=np.float32
    ).copy()
    collective_sessions << 1
    collective_steps << steps
    collective_session_us << elapsed * 1e6
    return own, elapsed


def _party_operand(seed: int, index: int, width: int) -> np.ndarray:
    rng = np.random.default_rng(seed + index)
    return rng.standard_normal(width).astype(np.float32)


def expected_mean(seed: int, nparties: int, width: int) -> np.ndarray:
    return np.mean(
        [_party_operand(seed, i, width) for i in range(nparties)], axis=0
    )


def _run_observed_session(party_ids, own_index, steps, width, seed, **kw):
    """run_collective_session under counter bookkeeping: a raise counts one
    error (shared by the handler and the proposer parties). The JAX
    module's session span around it waits for ROADMAP A12."""
    try:
        return run_collective_session(party_ids, own_index, steps, width, seed, **kw)
    except Exception:
        collective_errors << 1
        raise


def make_collective_handler(server):
    """Server half: accept a session proposal, run our party's chain, and
    answer with the final row's checksum once the chain drains (the
    response doubles as the completion barrier the proposer collects)."""

    runs = mc_dispatch.RunLimit(server.options.collective_max_concurrency)

    def collective(cntl, request: bytes) -> bytes:
        try:
            req = json.loads(request.decode())
            party_ids = [int(i) for i in req["parties"]]
            own_index = int(req["index"])
            steps = int(req["steps"])
            width = int(req["width"])
            seed = int(req["seed"])
            session_id = req.get("session_id") or None
        except (ValueError, KeyError, TypeError) as e:
            cntl.set_failed(ErrorCode.EREQUEST, f"bad collective proposal: {e}")
            return b""
        if not (0 < steps <= mc_dispatch.MAX_STEPS and 0 < width <= mc_dispatch.MAX_WIDTH):
            cntl.set_failed(ErrorCode.EREQUEST, "collective proposal out of bounds")
            return b""
        if req.get("phase") == "accept":
            # the accept pre-ack: the proposer waits for every party's
            # explicit accept BEFORE entering its own session. Beyond the
            # bounds above, every party id must be a rank of this
            # process's job (any label without one). Nothing runs here.
            try:
                mc_dispatch._party_ranks(party_ids)
            except ValueError as e:
                cntl.set_failed(ErrorCode.EREQUEST, str(e))
                return b""
            return json.dumps({"accept": True, "index": own_index}).encode()
        if not runs.enter():
            cntl.set_failed(ErrorCode.ELIMIT, berror(ErrorCode.ELIMIT))
            return b""
        # liveness: a party that never joins stalls the rendezvous until
        # the group's timeout errors the chain — the raise lands here
        # and answers EINTERNAL
        try:
            own, elapsed = _run_observed_session(
                party_ids, own_index, steps, width, seed,
                device=server.device(), session_id=session_id,
            )
        finally:
            runs.leave()
        return json.dumps(
            {
                "checksum": float(np.sum(own, dtype=np.float64)),
                "elapsed_s": elapsed,
                "steps": steps,
            }
        ).encode()

    return collective


def propose_collective(
    channels,
    party_ids: List[int],
    client_index: int,
    steps: int,
    width: int,
    seed: int,
    timeout_ms: float = 120000,
    device: DeviceLike = None,
):
    """Client half: propose the session to every server (async — they
    must all start dispatching, the collective needs every party), run
    our own party's chain (on ``device``), then collect completions.
    Returns {"own": row, "elapsed_s": s, "server_checksums": [...]}.

    ``channels[i]`` is a host channel to the server playing party
    ``server_indexes[i]``: servers take every index except
    ``client_index``, in order."""
    from incubator_brpc_tpu_torch.rpc.controller import Controller
    from incubator_brpc_tpu_torch.transport.device_link import HANDSHAKE_SERVICE

    server_indexes = [i for i in range(len(party_ids)) if i != client_index]
    if len(server_indexes) != len(channels):
        raise ValueError("one channel per server party required")
    session_id = uuid.uuid4().hex

    def proposal(idx: int, phase: str = "") -> bytes:
        d = {"parties": list(party_ids), "index": idx, "steps": steps, "width": width,
             "seed": seed, "session_id": session_id}
        if phase:
            d["phase"] = phase
        return json.dumps(d).encode()

    def fan_out(phase: str = ""):
        calls = []
        for ch, idx in zip(channels, server_indexes):
            cntl = Controller(timeout_ms=timeout_ms)
            ev = threading.Event()
            ch.call_method(HANDSHAKE_SERVICE, COLLECTIVE_METHOD, proposal(idx, phase),
                           cntl=cntl, done=lambda c, _ev=ev: _ev.set())
            calls.append((cntl, ev))
        return calls

    # Phase 1 — the explicit accept pre-ack from EVERY server: a rejection
    # surfaces here, before we enter a session whose collective would
    # wait on a party that never joins
    accept_deadline = time.monotonic() + timeout_ms / 1000.0
    for cntl, ev in fan_out("accept"):
        if not ev.wait(max(0.0, accept_deadline - time.monotonic())):
            raise TimeoutError("collective peer never acknowledged proposal")
        if cntl.failed():
            raise RuntimeError(f"collective proposal rejected: {cntl.error_text}")

    # Phase 2 — the run proposals (async: every party must be dispatching
    # before any can finish), then a short rejection watch: the accept
    # reserved nothing, so a run can still bounce at once (ELIMIT from an
    # overlapping session, a server mid-stop)
    pending = fan_out()
    watch_deadline = time.monotonic() + _REJECT_WATCH_S
    while time.monotonic() < watch_deadline:
        for cntl, ev in pending:
            if ev.is_set() and cntl.failed():
                raise RuntimeError(f"collective proposal rejected: {cntl.error_text}")
        time.sleep(0.005)
    own, elapsed = _run_observed_session(
        party_ids, client_index, steps, width, seed, device=device, session_id=session_id,
    )
    checksums = []
    deadline = time.monotonic() + timeout_ms / 1000.0  # shared, not per-peer
    for cntl, ev in pending:
        if not ev.wait(max(0.0, deadline - time.monotonic())):
            raise TimeoutError("collective peer never completed")
        if cntl.failed():
            raise RuntimeError(f"collective peer failed: {cntl.error_text}")
        checksums.append(json.loads(cntl.response_payload.decode())["checksum"])
    return {"own": own, "elapsed_s": elapsed, "server_checksums": checksums}
