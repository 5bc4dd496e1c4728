"""The RPC half of the port's collective session plane
(``parallel/mc_dispatch.py`` ``propose_dispatch``, ``make_dispatch_handler``,
``propose_with_recovery``, ``lower_parallel_call``; ``mc_collective.py``'s
``propose_collective``; the collective services of ``rpc/server.py``) on
the CPU, in process, against the JAX package's: the single-controller tier
of the JAX package's tests, where every party's server lives in this
process and each handler computes the whole session.

Each scenario runs on both packages (``pkg``): the JAX package's servers on
the conftest's virtual CPU devices (``device_index``), the port's with
``ServerOptions(device="cpu")`` (the kernels' plain versions); party ids
are the same integers on both (a JAX party id is a device id, the port's a
row label). The tests are those of tests/test_mc_dispatch.py
(``TestProposalValidation``, ``TestInProcessSessions`` but its two span
cases, ``TestMcLoweringRouting``), tests/test_overlap.py
(``TestChunkedSessions``, ``TestChunkedWatchdog``,
``TestOverlapChaosDrill``), tests/test_quantized.py
(``TestQuantizedSessions``, ``TestQuantizedProposals``,
``test_propose_dispatch_orders_by_synthetic_profile``), tests/test_parallel.py
(``TestCollectiveAcceptPreAck``) and tests/test_robustness.py
(``TestSessionAbortChaosDrill``, ``TestElasticResumeChaosDrill``,
``TestStepWatchdog``), with the same operands from the same seeds.

Tolerances: the integer ``_scale_psum_kernel`` sessions byte for byte with
``session_expected`` on both packages (so with each other); quantized
pmean sessions byte for byte between the packages and with
``np_quantized_pmean``, and within ``pmean_error_bound`` of the exact
session; the exact pmean byte for byte with the party-ordered f32 model
(``mc_worker.pmean_model``) on the port and, at the 2 parties where
the order of the sum cannot differ, on the JAX package (at 3 the JAX
package's ``lax.pmean`` adds in another order: within 1e-6 there).
``TestElasticResumeChaosDrill::test_kill_at_step_k_heals_byte_identical``
is held on the port alone, to the undisturbed model: ROADMAP C lists the
JAX package's case as flaky, and tests/test_robustness.py runs it.
"""

import base64
import contextlib
import importlib
import json
import threading
import time
import types

import jax
import numpy as np
import pytest

import incubator_brpc_tpu.parallel.mc_collective as jax_mcc
import incubator_brpc_tpu.parallel.mc_dispatch as jax_mcd
import incubator_brpc_tpu.parallel.quantized as jax_Q
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.transport.mc_worker as jax_worker
import incubator_brpc_tpu.utils.flags as jax_flags
import incubator_brpc_tpu_torch.parallel.mc_collective as port_mcc
import incubator_brpc_tpu_torch.parallel.mc_dispatch as port_mcd
import incubator_brpc_tpu_torch.parallel.quantized as port_Q
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.transport.mc_worker as port_worker
import incubator_brpc_tpu_torch.utils.flags as port_flags
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils.status import ErrorCode

# the modules, not the ``device_method`` functions their packages export
jax_dmod = importlib.import_module("incubator_brpc_tpu.rpc.device_method")
port_dmod = importlib.import_module("incubator_brpc_tpu_torch.rpc.device_method")

SESSION_WIDTH = port_worker.SESSION_WIDTH
WIDTH = 256  # the quantized tests' row: 64 floats = 2 blocks of 32

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", rpc=jax_rpc, mcd=jax_mcd, mcc=jax_mcc, Q=jax_Q, dmod=jax_dmod,
        worker=jax_worker, flags=jax_flags, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", rpc=port_rpc, mcd=port_mcd, mcc=port_mcc, Q=port_Q, dmod=port_dmod,
        worker=port_worker, flags=port_flags, server_kw={"device": "cpu"},
    ),
}

_OPEN = []  # servers and LB channels a test started, stopped at teardown


@pytest.fixture(autouse=True)
def nothing_outlives_the_test():
    # a server's device methods land in its package's registry: restore
    # both registries as they were, so no test sees another's methods
    saved = {name: dict(pkg.dmod._registry) for name, pkg in PKGS.items()}
    yield
    for name, pkg in PKGS.items():
        pkg.dmod._registry.clear()
        pkg.dmod._registry.update(saved[name])
    for pkg in PKGS.values():
        pkg.mcd.set_step_hook(None)
    while _OPEN:
        obj = _OPEN.pop()
        if isinstance(obj, (jax_rpc.Server, port_rpc.Server)):
            obj.stop()
            obj.join(timeout=10)
        elif obj._lb is not None:
            obj._lb.stop()
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture
def flags(pkg):
    """Set flags of ``pkg`` for one test; the old values come back after."""
    touched = {}

    def tune(name, value):
        if name not in touched:
            touched[name] = pkg.flags.flag_registry.get(name)
        pkg.flags.set_flag_unchecked(name, value)

    yield tune
    for name, value in touched.items():
        pkg.flags.set_flag_unchecked(name, value)


@pytest.fixture
def registered_scale(pkg):
    """("dsvc", "scale") bound CHUNK-SAFE to the package's psum+elementwise
    kernel in this process's registry (proposer and in-process servers
    share it)."""
    dm = pkg.dmod.DeviceMethod(pkg.worker._scale_psum_kernel, width=SESSION_WIDTH,
                               chunkable=True)
    prev = pkg.dmod.lookup_device_method("dsvc", "scale")
    pkg.dmod.register_device_method("dsvc", "scale", dm)
    yield dm
    if prev is not None:
        pkg.dmod.register_device_method("dsvc", "scale", prev)
    else:
        pkg.dmod.unregister_device_method("dsvc", "scale")


@pytest.fixture
def pmean_registered(pkg):
    dm = pkg.mcc._pmean_dm(WIDTH)
    prev = pkg.dmod.lookup_device_method("_collective", "pmean")
    pkg.dmod.register_device_method("_collective", "pmean", dm)
    yield dm
    # restore EXACTLY: a leaked registration would shadow the width-minting
    # pmean resolver for every other test
    if prev is not None:
        pkg.dmod.register_device_method("_collective", "pmean", prev)
    else:
        pkg.dmod.unregister_device_method("_collective", "pmean")


def servers(pkg, n, start_index=1, inline=True, chunkable=True, kernel=None, width=SESSION_WIDTH,
            scale=True):
    """n servers serving the collective services (no limit), each
    registering the kernel as the device method ``dsvc.scale``."""
    kernel = kernel or pkg.worker._scale_psum_kernel
    out = []
    for i in range(n):
        s = pkg.rpc.Server(pkg.rpc.ServerOptions(
            device_index=start_index + i, usercode_inline=inline,
            enable_collective_service=True, collective_max_concurrency=0, **pkg.server_kw))
        if scale:
            s.add_service("dsvc", {"scale": pkg.rpc.device_method(kernel, width=width,
                                                                  chunkable=chunkable)})
        assert s.start(0)
        _OPEN.append(s)
        out.append(s)
    return out


def channels(pkg, srvs, lb=False, timeout_ms=8000):
    chans = []
    for s in srvs:
        ch = pkg.rpc.Channel()
        if lb:
            # every party behind its own breaker-owning LB (list://), so a
            # drill can prove WHO is charged for a death
            assert ch.init(f"list://127.0.0.1:{s.port}", lb_name="rr",
                           options=pkg.rpc.ChannelOptions(max_retry=1, timeout_ms=timeout_ms))
            _OPEN.append(ch)
        else:
            assert ch.init(f"127.0.0.1:{s.port}")
        chans.append(ch)
    return chans


def kill(srv):
    srv.stop()
    srv.join(timeout=3)


@contextlib.contextmanager
def killed_at_step(pkg, srv, at, pace=0.03):
    """Pace every party's steps (``pace`` s each) and kill ``srv`` once a
    chain reaches step ``at``: the JAX tests kill on a wall-clock timer
    (about step ``at`` at this pace); progress keeps the kill mid-session on
    a loaded host that starts the session late."""
    reached = threading.Event()

    def hook(step, idx):
        if step >= at:
            reached.set()
        time.sleep(pace)

    def killer():
        if reached.wait(timeout=60):
            kill(srv)

    pkg.mcd.set_step_hook(hook)
    t = threading.Thread(target=killer, daemon=True)
    t.start()
    try:
        yield
    finally:
        reached.set()
        pkg.mcd.set_step_hook(None)
        t.join(timeout=10)


def rows(n, nfloats, seed=5, scale=3.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(nfloats) * scale * (i + 1)).astype(np.float32)
            for i in range(n)]


def wait_until(cond, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def proposal(dm, parties, **over):
    d = {"parties": parties, "index": 1, "steps": 2, "width": dm.width, "service": "dsvc",
         "method": "scale", "fingerprint": dm.fingerprint(), "phase": "accept"}
    d.update(over)
    return json.dumps(d).encode()


def call(pkg, ch, payload, method="collective_dispatch"):
    return ch.call_method("_tpu_transport", method, payload,
                          cntl=pkg.rpc.Controller(timeout_ms=30000))


# -- tests/test_mc_dispatch.py TestProposalValidation ---------------------------


def test_accept_validates_fingerprint(pkg, registered_scale):
    dm = registered_scale
    parties = [0, 1, 2]
    (ch,) = channels(pkg, servers(pkg, 1))
    ok = call(pkg, ch, proposal(dm, parties))
    assert ok.ok(), ok.error_text
    ack = json.loads(ok.response_payload.decode())
    assert ack["accept"] is True and ack["target"] == 2
    # same name, different fingerprint -> clean reject, no lockstep
    bad = call(pkg, ch, proposal(dm, parties, fingerprint="deadbeef00000000"))
    assert bad.failed() and bad.error_code == ErrorCode.EREQUEST
    assert "fingerprint mismatch" in bad.error_text
    # unknown method name -> ENOMETHOD
    miss = call(pkg, ch, proposal(dm, parties, method="nosuch"))
    assert miss.failed() and miss.error_code == ErrorCode.ENOMETHOD
    # geometry mismatch (width disagrees with the registration)
    assert call(pkg, ch, proposal(dm, parties, width=dm.width * 2)).failed()
    # out-of-bounds proposal
    oob = call(pkg, ch, proposal(dm, parties, steps=0))
    assert oob.failed() and oob.error_code == ErrorCode.EREQUEST


def test_run_phase_enforces_accept_floor(pkg, registered_scale, flags):
    flags("mc_dispatch_min_steps", 6)
    (ch,) = channels(pkg, servers(pkg, 1))
    low = call(pkg, ch, proposal(registered_scale, [0, 1], steps=2, phase=None))
    assert low.failed() and low.error_code == ErrorCode.EREQUEST
    assert "floor" in low.error_text


def test_reject_counter_advances(pkg, registered_scale):
    (ch,) = channels(pkg, servers(pkg, 1))
    before = pkg.mcd.dispatch_rejects.get_value()
    bad = call(pkg, ch, proposal(registered_scale, [0, 1], fingerprint="0" * 16))
    assert bad.failed()
    assert pkg.mcd.dispatch_rejects.get_value() == before + 1


def test_both_packages_reject_alike():
    """The accept phase's answers, code for code and text for text but the
    fingerprints, are the JAX package's."""
    answers = {}
    for name, pkg in PKGS.items():
        dm = pkg.dmod.DeviceMethod(pkg.worker._scale_psum_kernel, width=SESSION_WIDTH)
        pkg.dmod.register_device_method("dsvc", "scale", dm)
        try:
            (ch,) = channels(pkg, servers(pkg, 1))
            got = []
            for over in ({}, {"fingerprint": "0" * 16}, {"method": "nosuch"},
                         {"width": 2 * SESSION_WIDTH}, {"steps": 0}, {"quantize": "fp8"},
                         {"parties": [0, 0]}):
                over = dict(over)
                c = call(pkg, ch, proposal(dm, over.pop("parties", [0, 1, 2]), **over))
                text = c.error_text.replace(dm.fingerprint(), "FP")
                got.append((c.error_code, text if c.failed() else c.response_payload))
            answers[name] = got
        finally:
            pkg.dmod.unregister_device_method("dsvc", "scale")
    assert answers["torch"] == answers["jax"]


def test_party_id_must_be_a_rank_of_the_job(pkg, registered_scale):
    """The JAX package's ``_devices_by_id``, read as ranks: in a process
    of a job (here a one-process job over a local store), a party id that
    is no rank of the job is an EREQUEST at accept; without a job every id
    is a row label."""
    if pkg.name == "jax":
        # the JAX package's counterpart: a device id outside the global view
        (ch,) = channels(pkg, servers(pkg, 1))
        bad = call(pkg, ch, proposal(registered_scale, [0, 97]))
        assert bad.failed() and bad.error_code == ErrorCode.EREQUEST
        return
    from incubator_brpc_tpu_torch.utils import distributed as port_dist

    (ch,) = channels(pkg, servers(pkg, 1))
    assert call(pkg, ch, proposal(registered_scale, [0, 97])).ok()
    port_dist.init_job(0, 2, port_worker._free_ports(1)[0], "cpu")
    try:
        bad = call(pkg, ch, proposal(registered_scale, [0, 97]))
        assert bad.failed() and bad.error_code == ErrorCode.EREQUEST
        assert "no rank" in bad.error_text
        assert call(pkg, ch, proposal(registered_scale, [0, 1])).ok()
        with pytest.raises(ValueError, match="not addressable"):
            port_mcd.run_dispatch_session([0, 1], 1, registered_scale, [b"a", b"b"], 1,
                                          session_id="s")
    finally:
        port_dist.shutdown_job()


# -- tests/test_mc_dispatch.py TestInProcessSessions ----------------------------


def test_user_kernel_session_matches_integer_model(pkg, registered_scale):
    chans = channels(pkg, servers(pkg, 2))
    operands = [bytes(range(40)), bytes(range(100, 180))]
    out = pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", operands, steps=3,
                                   proposer_index=None, timeout_ms=60000)
    assert out["final_steps"] == 3
    assert out["results"] == port_worker.session_expected(operands, 3)


def test_nparty_close_converges_on_max_target(pkg, registered_scale, flags):
    """One party demands a deeper pipeline (mc_dispatch_min_steps): every
    accept answers max(2, 5) and every party runs exactly 5 steps."""
    flags("mc_dispatch_min_steps", 5)
    chans = channels(pkg, servers(pkg, 3))
    operands = [b"a" * 10, b"b" * 20, b"c" * 30]
    out = pkg.mcd.propose_dispatch(chans, [1, 2, 3], "dsvc", "scale", operands, steps=2,
                                   proposer_index=None, timeout_ms=60000)
    assert out["final_steps"] == 5
    assert out["results"] == port_worker.session_expected(operands, 5)


def test_byte_identical_with_the_fused_dispatch_model(pkg, registered_scale):
    """The JAX test holds a one-step session against the single-controller
    fused dispatch (ROADMAP A3 in the port); both packages hold it to the
    integer model of that dispatch's math, merged in party order."""
    operands = [bytes([i * 3]) * (20 + i) for i in range(3)]
    chans = channels(pkg, servers(pkg, 3))
    out = pkg.mcd.propose_dispatch(chans, [1, 2, 3], "dsvc", "scale", operands, steps=1,
                                   proposer_index=None, timeout_ms=60000)
    assert b"".join(out["results"]) == b"".join(port_worker.session_expected(operands, 1))


def test_proposer_as_party_and_per_kernel_counters(pkg, registered_scale):
    sessions_before = pkg.mcd.dispatch_sessions.get_value()
    kernel_before = pkg.mcd._method_counter("dsvc", "scale").get_value()
    chans = channels(pkg, servers(pkg, 1))
    operands = [b"proposer-side", b"server-side!!"]
    out = pkg.mcd.propose_dispatch(chans, [0, 1], "dsvc", "scale", operands, steps=2,
                                   proposer_index=0, timeout_ms=60000,
                                   **({"device": "cpu"} if pkg.name == "torch" else {}))
    assert out["elapsed_s"] is not None
    assert out["results"] == port_worker.session_expected(operands, 2)
    assert pkg.mcd.dispatch_sessions.get_value() >= sessions_before + 2
    assert pkg.mcd._method_counter("dsvc", "scale").get_value() >= kernel_before + 2


def test_pmean_is_just_one_registered_method(pkg):
    width = 32
    dm = pkg.mcd.resolve_method(pkg.mcc.PMEAN_SERVICE, pkg.mcc.PMEAN_METHOD, 4 * width)
    assert dm is not None and dm.width == 4 * width
    dm2 = pkg.mcd.resolve_method(pkg.mcc.PMEAN_SERVICE, pkg.mcc.PMEAN_METHOD, 4 * width)
    assert dm2.fingerprint() == dm.fingerprint()
    kw = {"device": "cpu"} if pkg.name == "torch" else {}
    own, _ = pkg.mcc.run_collective_session([0, 1, 2, 3], 2, 1, width, 11, **kw)
    np.testing.assert_allclose(own, pkg.mcc.expected_mean(11, 4, width), atol=1e-5)


# -- tests/test_mc_dispatch.py TestMcLoweringRouting ----------------------------


class _FakeLink:
    def __init__(self, party, mc=True):
        self._mesh = object()
        self.devices = [None, types.SimpleNamespace(id=party)]
        self.ranks = [0, party]
        if mc:
            self.own_side = 0


class _FakeSock:
    def __init__(self, link, fp_map):
        self.link = link
        self.device_methods = fp_map


class _FakeChannel:
    def __init__(self, ds):
        self._options = types.SimpleNamespace(transport="tpu")
        self._lb = None
        self._ds = ds
        self.host_calls = 0

    def _pick_socket(self, cntl):
        return self._ds

    def call_method(self, service, method, request, cntl=None, done=None):
        self.host_calls += 1
        cntl.response_payload = b"host:" + request
        if done:
            done(cntl)
        return cntl


def _lowering_pc(pkg, dm, mc_flags):
    from incubator_brpc_tpu.rpc.combo import ParallelChannel as JaxPC
    from incubator_brpc_tpu_torch.rpc.combo import ParallelChannel as PortPC

    pc = (JaxPC if pkg.name == "jax" else PortPC)(fuse_device_calls=True)
    for i, mc in enumerate(mc_flags):
        pc.add_channel(_FakeChannel(_FakeSock(_FakeLink(100 + i, mc=mc),
                                              {"dsvc.scale": dm.fingerprint()})))
    return pc


def test_all_mc_links_route_to_method_plane(pkg, registered_scale, monkeypatch):
    seen = {}

    def fake_lower(channels, parties, service, method, requests, timeout_ms):
        # the JAX package hands over devices, the port the servers' ranks
        seen["parties"] = [getattr(p, "id", p) for p in parties]
        seen["pair"] = (service, method)
        return [b"mc:" + r for r in requests]

    monkeypatch.setattr(pkg.mcd, "lower_parallel_call", fake_lower)
    pc = _lowering_pc(pkg, registered_scale, [True, True])
    cntl = pc.call_method("dsvc", "scale", b"req", cntl=pkg.rpc.Controller(timeout_ms=5000))
    assert cntl.ok(), cntl.error_text
    assert getattr(cntl, "collective_fused", False) is True
    assert cntl.response_payload == b"mc:reqmc:req"
    assert seen == {"parties": [100, 101], "pair": ("dsvc", "scale")}
    assert all(ch.host_calls == 0 for ch, _m, _r in pc._subs)


def test_mixed_planes_fall_back_to_host(pkg, registered_scale, monkeypatch):
    def boom(*a, **kw):  # the lowering must not even be attempted
        raise AssertionError("mixed planes must not lower")

    monkeypatch.setattr(pkg.mcd, "lower_parallel_call", boom)
    pc = _lowering_pc(pkg, registered_scale, [True, False])
    cntl = pc.call_method("dsvc", "scale", b"req", cntl=pkg.rpc.Controller(timeout_ms=5000))
    assert cntl.ok(), cntl.error_text
    assert getattr(cntl, "collective_fused", False) is False
    assert cntl.response_payload == b"host:reqhost:req"


def test_failed_lowering_falls_back_to_host(pkg, registered_scale, monkeypatch):
    def fail_lower(*a, **kw):
        raise RuntimeError("peer rejected")

    monkeypatch.setattr(pkg.mcd, "lower_parallel_call", fail_lower)
    pc = _lowering_pc(pkg, registered_scale, [True, True])
    cntl = pc.call_method("dsvc", "scale", b"req", cntl=pkg.rpc.Controller(timeout_ms=5000))
    assert cntl.ok(), cntl.error_text
    assert getattr(cntl, "collective_fused", False) is False
    assert cntl.response_payload == b"host:reqhost:req"


def test_lowering_runs_the_session_in_process(pkg, registered_scale):
    """``lower_parallel_call`` itself over in-process servers: a one-step
    session of the method, each party's operand its sub-request, merged
    bytes the integer model's."""
    chans = channels(pkg, servers(pkg, 3))
    reqs = [bytes(range(i, i + 30)) for i in range(3)]
    parties = [1, 2, 3]
    if pkg.name == "jax":
        parties = [jax.devices()[i] for i in parties]
    outs = pkg.mcd.lower_parallel_call(chans, parties, "dsvc", "scale", reqs, 30000)
    assert outs == port_worker.session_expected(reqs, 1)


# -- tests/test_overlap.py TestChunkedSessions, TestChunkedWatchdog -------------


@pytest.mark.parametrize("chunks,double_buffer",
                         [(1, False), (4, False), (4, True), (1, True), (8, True)])
def test_every_schedule_matches_integer_model(pkg, registered_scale, chunks, double_buffer):
    chans = channels(pkg, servers(pkg, 2))
    operands = [bytes(range(40)), bytes(range(100, 180))]
    out = pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", operands, steps=3,
                                   proposer_index=None, timeout_ms=60000, chunks=chunks,
                                   double_buffer=double_buffer)
    assert out["final_steps"] == 3
    assert out["results"] == port_worker.session_expected(operands, 3)


def test_degenerate_path_is_the_pre_overlap_code(pkg, registered_scale):
    chans = channels(pkg, servers(pkg, 2))
    operands = [b"\x05" * 16, b"\x09" * 24]
    before = pkg.mcd.dispatch_chunks.get_value()
    pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", operands, steps=2,
                             proposer_index=None, timeout_ms=60000)
    assert pkg.mcd.dispatch_chunks.get_value() == before
    pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", operands, steps=2,
                             proposer_index=None, timeout_ms=60000, chunks=2)
    # 2 parties x 2 steps x 2 chunks
    assert pkg.mcd.dispatch_chunks.get_value() == before + 8


def test_overlap_ratio_gauge_reads(pkg):
    assert 0.0 <= pkg.mcd.overlap_ratio_gauge.get_value() <= 1.0


def test_proposer_rejects_unchunkable_kernel(pkg):
    pkg.dmod.register_device_method(
        "dsvc", "plain_scale",
        pkg.dmod.DeviceMethod(pkg.worker._scale_psum_kernel, width=SESSION_WIDTH))
    try:
        with pytest.raises(ValueError, match="chunk"):
            pkg.mcd.propose_dispatch([None], [0, 1], "dsvc", "plain_scale", [b"a", b"b"],
                                     steps=1, proposer_index=0, chunks=2)
    finally:
        pkg.dmod.unregister_device_method("dsvc", "plain_scale")


def test_proposer_rejects_bad_chunk_geometry(pkg, registered_scale):
    with pytest.raises(ValueError, match="divide"):
        pkg.mcd.propose_dispatch([None], [0, 1], "dsvc", "scale", [b"a", b"b"], steps=1,
                                 proposer_index=0, chunks=3)
    with pytest.raises(ValueError, match="chunks"):
        pkg.mcd.propose_dispatch([None], [0, 1], "dsvc", "scale", [b"a", b"b"], steps=1,
                                 proposer_index=0, chunks=pkg.mcd.MAX_CHUNKS + 1)


def test_party_without_chunkable_registration_rejects(pkg):
    (ch,) = channels(pkg, servers(pkg, 1, chunkable=False))
    fp = pkg.dmod.DeviceMethod(pkg.worker._scale_psum_kernel, width=SESSION_WIDTH).fingerprint()
    before = pkg.mcd.dispatch_rejects.get_value()
    run = {"parties": [1, 2], "index": 0, "steps": 1, "width": SESSION_WIDTH, "service": "dsvc",
           "method": "scale", "fingerprint": fp,
           "operands": [base64.b64encode(b"\x01" * 8).decode(),
                        base64.b64encode(b"\x02" * 8).decode()],
           "chunks": 2}
    cntl = call(pkg, ch, json.dumps(run).encode())
    assert cntl.failed() and cntl.error_code == ErrorCode.EREQUEST
    assert "chunkable" in cntl.error_text
    assert pkg.mcd.dispatch_rejects.get_value() == before + 1


def test_watchdog_abort_names_step_and_chunk(pkg, registered_scale):
    chans = channels(pkg, servers(pkg, 3))
    operands = [bytes([i + 1]) * 8 for i in range(3)]
    before = pkg.mcd.dispatch_aborts.get_value()
    # a loaded host can spend a few hundred ms on an early step: the step
    # deadline sits well above that and well below the stall
    stall_s = 4.0

    def hook(step, idx, chunk):
        if idx == 1 and step == 2 and chunk == 1:
            time.sleep(stall_s)  # wedged inside step 2 chunk 1

    pkg.mcd.set_step_hook(hook)
    t0 = time.monotonic()
    with pytest.raises(pkg.mcd.SessionAborted) as exc:
        pkg.mcd.propose_dispatch(chans, [1, 2, 3], "dsvc", "scale", operands, steps=30,
                                 proposer_index=None, timeout_ms=60000,
                                 session_deadline_ms=30000, step_deadline_ms=1500, chunks=2,
                                 double_buffer=True)
    elapsed = time.monotonic() - t0
    pkg.mcd.set_step_hook(None)
    assert elapsed < stall_s + 4.0
    msg = str(exc.value)
    assert "step deadline" in msg and "step 2 chunk 1/2" in msg, msg
    assert pkg.mcd.dispatch_aborts.get_value() > before


# -- tests/test_quantized.py TestQuantizedSessions, TestQuantizedProposals ------


def _run(pkg, dm, rws, steps, **kw):
    ops = [r.tobytes() for r in rws]
    if pkg.name == "torch":
        kw["device"] = "cpu"
    row, n, _ = pkg.mcd.run_dispatch_session(list(range(len(rws))), 0, dm, ops, steps,
                                             service="_collective", method="pmean", **kw)
    return np.frombuffer(bytes(np.asarray(row[:n], np.uint8)), np.float32)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_session_matches_model_and_bound(mode):
    """Both packages' quantized sessions are byte for byte each other and
    ``np_quantized_pmean``, within the bound of the exact session."""
    rws = rows(3, WIDTH // 4, seed=7)
    steps = 2
    got = {}
    for name, pkg in PKGS.items():
        dm = pkg.mcc._pmean_dm(WIDTH)
        exact = _run(pkg, dm, rws, steps)
        got[name] = _run(pkg, dm, rws, steps, quantize=mode)
        assert float(np.abs(got[name] - exact).max()) <= pkg.Q.pmean_error_bound(rws, steps, mode)
    assert got["torch"].tobytes() == got["jax"].tobytes()
    assert got["torch"].tobytes() == port_Q.np_quantized_pmean(rws, steps, mode).tobytes()


def test_exact_session_is_the_party_ordered_mean():
    rws = rows(3, WIDTH // 4, seed=9)
    model = port_worker.pmean_model(rws, 2)
    assert _run(PKGS["torch"], port_mcc._pmean_dm(WIDTH), rws, 2).tobytes() == model.tobytes()
    np.testing.assert_allclose(_run(PKGS["jax"], jax_mcc._pmean_dm(WIDTH), rws, 2), model,
                               rtol=0, atol=1e-6)
    two = rws[:2]
    assert (_run(PKGS["jax"], jax_mcc._pmean_dm(WIDTH), two, 2).tobytes()
            == port_worker.pmean_model(two, 2).tobytes())


def test_determinism_across_repeat_runs(pkg):
    dm = pkg.mcc._pmean_dm(WIDTH)
    rws = rows(3, WIDTH // 4, seed=8)
    a = _run(pkg, dm, rws, 2, quantize="int8")
    assert a.tobytes() == _run(pkg, dm, rws, 2, quantize="int8").tobytes()


def test_all_parties_converge_to_identical_bytes(pkg, pmean_registered):
    chans = channels(pkg, servers(pkg, 2, scale=False))
    rws = rows(2, WIDTH // 4, seed=17)
    out = pkg.mcd.propose_dispatch(chans, [1, 2], "_collective", "pmean",
                                   [r.tobytes() for r in rws], steps=2, proposer_index=None,
                                   timeout_ms=60000, quantize="int8")
    assert out["results"][0] == out["results"][1]
    assert out["results"][0] == port_Q.np_quantized_pmean(rws, 2, "int8").tobytes()
    assert out["quantize"] == "int8"
    assert out["wire_bytes"] == pkg.Q.wire_bytes(WIDTH, "int8") * 2 * 2


def test_overlap_composes_byte_identically(pkg):
    dm = pkg.mcc._pmean_dm(WIDTH)
    rws = rows(3, WIDTH // 4, seed=10)
    base = _run(pkg, dm, rws, 2, quantize="int8")
    assert _run(pkg, dm, rws, 2, quantize="int8", chunks=2,
                double_buffer=True).tobytes() == base.tobytes()
    assert _run(pkg, dm, rws, 2, quantize="int8", chunks=2, double_buffer=True,
                chunk_order=[1, 0]).tobytes() == base.tobytes()


def test_misaligned_chunks_reject_pre_lockstep(pkg):
    v8 = pkg.mcc._pmean_dm(WIDTH).quantized("int8")
    with pytest.raises(ValueError, match="block alignment"):
        pkg.mcd._validate_chunks(v8, 4, "_collective", "pmean")


def test_misdeclared_nonchunkable_variant_rejects(pkg):
    base = pkg.dmod.DeviceMethod(pkg.Q._make_quantized_pmean_kernel("int8", 32), width=WIDTH,
                                 chunkable=True)
    bad = pkg.dmod.DeviceMethod(pkg.Q._make_quantized_pmean_kernel("int8", 32), width=WIDTH,
                                chunkable=False)
    bad.quant_mode = "int8"
    base.quant_variants["int8"] = bad
    with pytest.raises(ValueError, match="not registered chunkable"):
        pkg.mcd._validate_chunks(base.quantized("int8"), 2, "svc", "m")


def test_quantized_bvars_and_wire_accounting(pkg):
    rws = rows(3, WIDTH // 4, seed=13)
    q0 = pkg.mcd.dispatch_quantized_sessions.get_value()
    s0 = pkg.mcd.dispatch_bytes_saved.get_value()
    _run(pkg, pkg.mcc._pmean_dm(WIDTH), rws, 2, quantize="int8")
    assert pkg.mcd.dispatch_quantized_sessions.get_value() == q0 + 1
    assert (pkg.mcd.dispatch_bytes_saved.get_value() - s0
            == (WIDTH - pkg.Q.wire_bytes(WIDTH, "int8")) * 3 * 2)


def test_quantized_checkpoint_ring_shrinks_and_resumes(pkg):
    dm = pkg.mcc._pmean_dm(WIDTH)
    rws = rows(3, WIDTH // 4, seed=14)
    sid = f"quantized-ring-{pkg.name}"
    full = _run(pkg, dm, rws, 4, quantize="int8", session_id=sid, checkpoint_every=2)
    ring = pkg.mcd._checkpoint_lookup(sid, 0)
    assert ring is not None and ring.watermark() >= 2
    assert ring.entry_bytes == 3 * (pkg.Q.wire_bytes(WIDTH, "int8") + 4)
    entry = ring.get(2)
    assert entry is not None and isinstance(entry[0], pkg.mcd._QuantCk)
    resumed = _run(pkg, dm.quantized("int8"), rws, 4, session_id=sid, resume_from=2,
                   checkpoint_every=2)
    assert resumed.tobytes() == full.tobytes()
    pkg.mcd.release_checkpoints(sid)


def test_reshard_rows_dequantize_to_full_width(pkg):
    rws = rows(3, WIDTH // 4, seed=15)
    sid = f"quantized-reshard-{pkg.name}"
    _run(pkg, pkg.mcc._pmean_dm(WIDTH), rws, 2, quantize="int8", session_id=sid,
         checkpoint_every=2)
    fetched = pkg.mcd.checkpoint_fetch(sid, 2, [0, 1, 2])
    assert sorted(fetched) == [0, 1, 2]
    for info in fetched.values():
        raw = base64.b64decode(info["row"])
        assert len(raw) == WIDTH and np.isfinite(np.frombuffer(raw, np.float32)).all()
    pkg.mcd.release_checkpoints(sid)


def test_accept_validates_quantized_fingerprint(pkg):
    (ch,) = channels(pkg, servers(pkg, 1, scale=False))
    v8 = pkg.mcc._pmean_dm(WIDTH).quantized("int8")

    def qprop(fp, **over):
        d = {"parties": [0, 1, 2], "index": 1, "steps": 2, "width": WIDTH,
             "service": "_collective", "method": "pmean", "fingerprint": fp, "phase": "accept"}
        d.update(over)
        return json.dumps(d).encode()

    assert call(pkg, ch, qprop(v8.fingerprint(), quantize="int8")).ok()
    # the EXACT kernel's fingerprint under quantize=int8 is a divergence
    wrong = call(pkg, ch, qprop(pkg.mcc._pmean_dm(WIDTH).fingerprint(), quantize="int8"))
    assert wrong.failed() and wrong.error_code == ErrorCode.EREQUEST
    assert "fingerprint mismatch" in wrong.error_text
    # a method with NO quantized variant: clean pre-lockstep reject
    plain = pkg.dmod.DeviceMethod(pkg.mcc._pmean_bytes_kernel, width=WIDTH)
    pkg.dmod.register_device_method("qsvc", "plain", plain)
    try:
        odd = call(pkg, ch, qprop(plain.fingerprint(), quantize="int8", service="qsvc",
                                  method="plain"))
        assert odd.failed() and "no int8 quantized variant" in odd.error_text
    finally:
        pkg.dmod.unregister_device_method("qsvc", "plain")
    bad = call(pkg, ch, qprop(v8.fingerprint(), quantize="fp8"))
    assert bad.failed() and "unknown quantize mode" in bad.error_text


def test_bad_chunk_order_rejects(pkg):
    (ch,) = channels(pkg, servers(pkg, 1, scale=False))
    v8 = pkg.mcc._pmean_dm(WIDTH).quantized("int8")
    run = {"parties": [0, 1], "index": 1, "steps": 2, "width": WIDTH, "service": "_collective",
           "method": "pmean", "fingerprint": v8.fingerprint(), "quantize": "int8", "chunks": 2,
           "chunk_order": [0, 0], "operands": ["", ""]}
    c = call(pkg, ch, json.dumps(run).encode())
    assert c.failed() and c.error_code == ErrorCode.EREQUEST and "chunk_order" in c.error_text


def test_propose_dispatch_orders_by_synthetic_profile(pkg, registered_scale):
    chans = channels(pkg, servers(pkg, 2))
    # party 1 (second in mesh order) measures SLOWEST
    prof = {1: {"gbps": 4.0, "rtt_us": 10.0}, 2: {"gbps": 0.05, "rtt_us": 2000.0}}
    operands = [bytes(range(40)), bytes(range(80, 160))]
    out = pkg.mcd.propose_dispatch(chans, [1, 2], "dsvc", "scale", operands, steps=2,
                                   proposer_index=None, timeout_ms=60000, chunks=4,
                                   double_buffer=True, link_profile=prof)
    assert out["results"] == port_worker.session_expected(operands, 2)
    assert out["link_order"] == [1, 0]
    # slice j's owner is j % 2: party 1 owns slices 1 and 3
    assert out["chunk_order"] == [1, 3, 0, 2]


# -- tests/test_parallel.py TestCollectiveAcceptPreAck --------------------------


def test_accept_phase_validates_without_running(pkg, monkeypatch):
    def boom(*a, **kw):  # the accept phase must never run a session
        raise AssertionError("accept phase ran the session")

    monkeypatch.setattr(pkg.mcc, "run_collective_session", boom)
    (ch,) = channels(pkg, servers(pkg, 1, scale=False))
    base = {"parties": [0, 1], "index": 1, "steps": 3, "width": 4, "seed": 7, "phase": "accept"}
    c = call(pkg, ch, json.dumps(base).encode(), method="collective")
    assert c.ok(), c.error_text
    assert json.loads(c.response_payload.decode()) == {"accept": True, "index": 1}
    bad = call(pkg, ch, json.dumps(dict(base, steps=0)).encode(), method="collective")
    assert bad.failed()


def test_propose_runs_without_grace_window(pkg, monkeypatch):
    calls = []

    def stub(parties, idx, steps, width, seed, **kw):
        calls.append(idx)
        return np.zeros(width, np.float32), 0.001

    monkeypatch.setattr(pkg.mcc, "run_collective_session", stub)
    (ch,) = channels(pkg, servers(pkg, 1, scale=False))
    t0 = time.monotonic()
    out = pkg.mcc.propose_collective([ch], [0, 1], client_index=0, steps=3, width=4, seed=7,
                                     timeout_ms=30000)
    assert len(out["server_checksums"]) == 1
    assert sorted(calls) == [0, 1]
    assert pkg.mcc._REJECT_WATCH_S <= 0.1
    assert time.monotonic() - t0 < 5.0


def test_collective_session_over_rpc_converges(pkg):
    """``propose_collective`` end to end: the proposer and two servers run
    a pmean session of 64 floats, every party at the global mean."""
    chans = channels(pkg, servers(pkg, 2, scale=False))
    kw = {"device": "cpu"} if pkg.name == "torch" else {}
    out = pkg.mcc.propose_collective(chans, [0, 1, 2], client_index=0, steps=2, width=64,
                                     seed=3, timeout_ms=30000, **kw)
    want = port_mcc.expected_mean(3, 3, 64)
    np.testing.assert_allclose(out["own"], want, atol=1e-5)
    for cs in out["server_checksums"]:
        assert abs(cs - float(np.sum(want, dtype=np.float64))) < 1e-3


def _parked_run(pkg, limit):
    """A server with ``collective_max_concurrency=limit`` and one run of a
    session parked on a step hook (it holds a slot until ``release``)."""
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(
        device_index=1, enable_collective_service=True, collective_max_concurrency=limit,
        **pkg.server_kw))
    srv.add_service("dsvc", {"scale": pkg.rpc.device_method(pkg.worker._scale_psum_kernel,
                                                            width=SESSION_WIDTH)})
    assert srv.start(0)
    _OPEN.append(srv)
    (ch,) = channels(pkg, [srv])
    dm = pkg.dmod.lookup_device_method("dsvc", "scale")
    release = threading.Event()
    pkg.mcd.set_step_hook(lambda step: release.wait(10))

    def run(sid):
        d = json.loads(proposal(dm, [0, 1], phase=None, index=0).decode())
        d.update(operands=[base64.b64encode(b"\x01").decode()] * 2, session_id=sid,
                 deadline_ms=30000)
        return json.dumps(d).encode()

    first = pkg.rpc.Controller(timeout_ms=30000)
    done = threading.Event()
    ch.call_method("_tpu_transport", "collective_dispatch", run("parked"), cntl=first,
                   done=lambda c: done.set())
    assert wait_until(lambda: pkg.mcd.active_sessions(owner=srv) == 1)
    return srv, ch, dm, run, release, first, done


def test_collective_max_concurrency_answers_elimit(pkg):
    """Past ``collective_max_concurrency`` session runs, a run proposal is
    refused with ELIMIT (the first run parks on a step hook); the parked
    run then finishes."""
    srv, ch, dm, run, release, first, done = _parked_run(pkg, 1)
    second = call(pkg, ch, run("second"))
    assert second.failed() and second.error_code == ErrorCode.ELIMIT
    release.set()
    assert done.wait(30) and first.ok(), first.error_text


def test_aborts_and_accepts_pass_the_limit():
    """While a run holds the only slot, the port's server answers an accept
    and the abort broadcast (the abort ends the parked run with ESESSION);
    the JAX package's method limit refuses both with ELIMIT, so there an
    abort waits for the session's deadline (ROADMAP C)."""
    for name, pkg in PKGS.items():
        srv, ch, dm, run, release, first, done = _parked_run(pkg, 1)
        accept = call(pkg, ch, proposal(dm, [0, 1]))
        abort = call(pkg, ch, json.dumps({"phase": "abort", "session_id": "parked",
                                          "reason": "test", "epoch": 0}).encode())
        if name == "torch":
            assert accept.ok() and abort.ok(), (accept.error_text, abort.error_text)
            assert json.loads(abort.response_payload.decode()) == {"aborted": True}
            release.set()
            assert done.wait(30) and first.error_code == ErrorCode.ESESSION, first.error_text
        else:
            assert accept.error_code == abort.error_code == ErrorCode.ELIMIT
            release.set()
            assert done.wait(30) and first.ok(), first.error_text
        pkg.mcd.set_step_hook(None)


def test_collective_services_are_opt_in(pkg):
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(device_index=1, **pkg.server_kw))
    assert srv.start(0)
    _OPEN.append(srv)
    (ch,) = channels(pkg, [srv])
    c = call(pkg, ch, b"{}")
    assert c.failed() and c.error_code in (ErrorCode.ENOMETHOD, ErrorCode.ENOSERVICE)


# -- tests/test_robustness.py TestSessionAbortChaosDrill ------------------------


@pytest.fixture
def drill(pkg, flags, registered_scale):
    """4 servers (3 parties + 1 spare) on the worker pool, each behind its
    own rr LB channel with a breaker."""
    flags("circuit_breaker_short_window_size", 30)
    flags("circuit_breaker_long_window_size", 300)
    flags("circuit_breaker_min_isolation_duration_ms", 60000)
    flags("enable_circuit_breaker", True)
    srvs = servers(pkg, 4, inline=False)
    return srvs, channels(pkg, srvs, lb=True, timeout_ms=10000), [1, 2, 3], 4


def _breakers_blame_the_dead(pkg, chans):
    for _ in range(30):
        if chans[0]._lb.isolated_servers():
            break
        chans[0].call_method("dsvc", "scale", b"x")
    assert chans[0]._lb.isolated_servers(), "dead party's breaker never tripped"
    for i in (1, 2):
        assert not chans[i]._lb.isolated_servers(), f"survivor {i}'s breaker tripped"


def test_party_death_aborts_survivors_and_recovery_succeeds(pkg, drill):
    srvs, chans, party_ids, _spare = drill
    deadline_ms = 4000
    operands = [bytes([i + 1]) * 8 for i in range(3)]
    before_aborts = pkg.mcd.dispatch_aborts.get_value()
    t0 = time.monotonic()
    with killed_at_step(pkg, srvs[0], at=12):
        with pytest.raises(pkg.mcd.SessionAborted) as exc:
            pkg.mcd.propose_dispatch(chans[:3], party_ids, "dsvc", "scale", operands, steps=120,
                                     proposer_index=None, timeout_ms=30000,
                                     session_deadline_ms=deadline_ms)
    assert time.monotonic() - t0 < 2 * deadline_ms / 1000.0
    assert exc.value.dead_indexes == (0,)
    assert exc.value.survivor_indexes == (1, 2)
    assert exc.value.error_code == ErrorCode.ESESSION
    assert wait_until(lambda: srvs[1]._nprocessing == 0 and srvs[2]._nprocessing == 0
                      and pkg.mcd.active_sessions() == 0,
                      timeout=max(0.1, t0 + 2 * deadline_ms / 1000.0 - time.monotonic()))
    assert pkg.mcd.dispatch_aborts.get_value() > before_aborts
    pkg.mcd.set_step_hook(None)
    _breakers_blame_the_dead(pkg, chans)
    out = pkg.mcd.propose_dispatch(chans[1:3], party_ids[1:], "dsvc", "scale", operands[1:],
                                   steps=2, proposer_index=None, timeout_ms=30000)
    assert out["results"] == port_worker.session_expected(operands[1:], 2)


def test_propose_with_recovery_drops_dead_party(pkg, drill):
    srvs, chans, party_ids, _spare = drill
    operands = [bytes([i + 1]) * 8 for i in range(3)]
    with killed_at_step(pkg, srvs[0], at=10):
        out = pkg.mcd.propose_with_recovery(chans[:3], party_ids, "dsvc", "scale", operands,
                                            steps=40, proposer_index=None, timeout_ms=30000,
                                            session_deadline_ms=4000)
    assert out["dead_party_ids"] == [party_ids[0]]
    assert out["final_steps"] == 40
    assert out["results"] == port_worker.session_expected(operands[1:], 40)


def test_esession_excluded_from_breaker_cost(pkg, flags):
    flags("circuit_breaker_short_window_size", 10)
    flags("enable_circuit_breaker", True)
    srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
    srv.add_service("e", {"m": lambda c, r: b"ok"})
    assert srv.start(0)
    _OPEN.append(srv)
    ch = pkg.rpc.Channel()
    assert ch.init(f"list://127.0.0.1:{srv.port}", lb_name="rr",
                   options=pkg.rpc.ChannelOptions(max_retry=0, timeout_ms=2000))
    _OPEN.append(ch)
    lb = ch._lb
    assert ch.call_method("e", "m", b"x").ok()
    sock = lb.select_server()
    for _ in range(50):
        lb.feedback(sock, 1000.0, ErrorCode.ESESSION)
        lb.feedback(sock, 1000.0, ErrorCode.EDEADLINE)
    assert not lb.isolated_servers()
    for _ in range(50):
        lb.feedback(sock, 1000.0, ErrorCode.EFAILEDSOCKET)
        if lb.isolated_servers():
            break
    assert lb.isolated_servers()


# -- tests/test_robustness.py TestElasticResumeChaosDrill, TestStepWatchdog -----


@pytest.mark.parametrize("pkg", ["torch"], indirect=True)
def test_kill_at_step_k_heals_byte_identical(pkg, drill):
    """The port alone (see the module docstring): 1 of 3 parties dies
    mid-session, the spare fills its slot, the session resumes from a
    common checkpoint, and every row equals the undisturbed model."""
    srvs, chans, party_ids, spare = drill
    steps = 80
    operands = [bytes([i + 1]) * 8 for i in range(3)]
    resumes, replaced = (port_mcd.dispatch_resumes.get_value(),
                         port_mcd.dispatch_replaced_parties.get_value())
    with killed_at_step(pkg, srvs[0], at=12):
        out = port_mcd.propose_with_recovery(chans[:3], party_ids, "dsvc", "scale", operands,
                                             steps=steps, proposer_index=None, timeout_ms=60000,
                                             session_deadline_ms=6000,
                                             spares=[(chans[3], spare)], checkpoint_every=2)
    assert out["dead_party_ids"] == [party_ids[0]]
    assert out["replaced_party_ids"] == [spare]
    assert out["resumed_from"] is not None and out["resumed_from"] > 0
    assert out["resumed_from"] % 2 == 0
    assert out["final_steps"] == steps
    assert out["results"] == port_worker.session_expected(operands, steps)
    assert port_mcd.dispatch_resumes.get_value() > resumes
    assert port_mcd.dispatch_replaced_parties.get_value() > replaced
    _breakers_blame_the_dead(pkg, chans)


def test_two_party_session_heals_with_spare(pkg, drill):
    srvs, chans, party_ids, spare = drill
    ops = [b"\x01" * 8, b"\x02" * 8]
    with killed_at_step(pkg, srvs[0], at=10):
        out = pkg.mcd.propose_with_recovery(chans[:2], party_ids[:2], "dsvc", "scale", ops,
                                            steps=40, proposer_index=None, timeout_ms=60000,
                                            session_deadline_ms=6000,
                                            spares=[(chans[3], spare)], checkpoint_every=2)
    assert out["replaced_party_ids"] == [spare]
    assert out["dead_party_ids"] == [party_ids[0]]
    assert [bytes(r) for r in out["results"]] == port_worker.session_expected(
        ops, out["final_steps"])


def test_quantized_overlapped_session_resumes_byte_identical(pkg, drill, pmean_registered):
    srvs, chans, party_ids, spare = drill
    rng = np.random.default_rng(21)
    rws = [(rng.standard_normal(WIDTH // 4) * (i + 1)).astype(np.float32) for i in range(3)]
    operands = [r.tobytes() for r in rws]
    kw = dict(steps=40, proposer_index=None, timeout_ms=60000, session_deadline_ms=6000,
              checkpoint_every=2, quantize="int8", chunks=2, double_buffer=True)
    pkg.mcd.set_step_hook(lambda step, idx: time.sleep(0.03))
    try:
        control = pkg.mcd.propose_with_recovery(chans[:3], party_ids, "_collective", "pmean",
                                                operands, **kw)
    finally:
        pkg.mcd.set_step_hook(None)
    with killed_at_step(pkg, srvs[0], at=6):
        out = pkg.mcd.propose_with_recovery(chans[:3], party_ids, "_collective", "pmean",
                                            operands, spares=[(chans[3], spare)], **kw)
    assert out["replaced_party_ids"] == [spare]
    assert out["resumed_from"] is not None and out["resumed_from"] > 0
    assert out["resumed_from"] % 2 == 0
    assert out["results"] == control["results"]
    assert control["results"][0] == port_Q.np_quantized_pmean(rws, 40, "int8").tobytes()
    assert out["quantize"] == "int8"
    replayed = out["final_steps"] - out["resumed_from"]
    assert out["wire_bytes"] == pkg.Q.wire_bytes(WIDTH, "int8") * 3 * replayed
    exact = np.mean(np.stack(rws), axis=0, dtype=np.float32)
    got = np.frombuffer(out["results"][0], dtype=np.float32)
    assert float(np.abs(got - exact).max()) <= pkg.Q.pmean_error_bound(rws, 40, "int8")


def test_no_spare_falls_back_to_shrink_restart(pkg, drill):
    srvs, chans, party_ids, _spare = drill
    operands = [bytes([i + 1]) * 8 for i in range(3)]
    with killed_at_step(pkg, srvs[0], at=10):
        out = pkg.mcd.propose_with_recovery(chans[:3], party_ids, "dsvc", "scale", operands,
                                            steps=30, proposer_index=None, timeout_ms=60000,
                                            session_deadline_ms=6000, checkpoint_every=2)
    assert out["dead_party_ids"] == [party_ids[0]]
    assert out["replaced_party_ids"] == []
    assert out["resumed_from"] is None
    want = port_worker.session_expected(operands[1:], out["final_steps"])
    assert out["results"] == want


def test_watchdog_fires_inside_stuck_step(pkg, registered_scale):
    chans = channels(pkg, servers(pkg, 3, inline=False))
    operands = [bytes([i + 1]) * 8 for i in range(3)]
    before = pkg.mcd.dispatch_aborts.get_value()
    stall_s = 2.5

    def hook(step, idx):
        if idx == 1 and step == 2:
            time.sleep(stall_s)  # wedged inside step 2

    pkg.mcd.set_step_hook(hook)
    t0 = time.monotonic()
    with pytest.raises(pkg.mcd.SessionAborted) as exc:
        pkg.mcd.propose_dispatch(chans, [1, 2, 3], "dsvc", "scale", operands, steps=30,
                                 proposer_index=None, timeout_ms=60000,
                                 session_deadline_ms=30000, step_deadline_ms=150)
    pkg.mcd.set_step_hook(None)
    assert time.monotonic() - t0 < stall_s + 4.0
    assert "step deadline" in str(exc.value)
    assert pkg.mcd.dispatch_aborts.get_value() > before
    assert wait_until(lambda: pkg.mcd.active_sessions() == 0, timeout=10)


# -- tests/test_overlap.py TestOverlapChaosDrill --------------------------------


def test_death_mid_chunked_step_heals_at_step_boundary(pkg, drill):
    srvs, chans, party_ids, spare = drill
    steps = 60
    operands = [bytes([i + 1]) * 8 for i in range(3)]
    kill_now = threading.Event()

    def hook(step, idx, chunk):
        if step >= 12 and chunk >= 2:
            kill_now.set()
        time.sleep(0.008)

    def killer_body():
        if kill_now.wait(timeout=30):
            kill(srvs[0])

    pkg.mcd.set_step_hook(hook)
    killer = threading.Thread(target=killer_body, daemon=True)
    killer.start()
    try:
        out = pkg.mcd.propose_with_recovery(chans[:3], party_ids, "dsvc", "scale", operands,
                                            steps=steps, proposer_index=None, timeout_ms=60000,
                                            session_deadline_ms=6000,
                                            spares=[(chans[3], spare)], checkpoint_every=2,
                                            chunks=4, double_buffer=True)
    finally:
        kill_now.set()
        pkg.mcd.set_step_hook(None)
        killer.join(timeout=5)
    assert out["dead_party_ids"] == [party_ids[0]]
    assert out["replaced_party_ids"] == [spare]
    assert out["resumed_from"] is not None and out["resumed_from"] > 0
    assert out["resumed_from"] % 2 == 0
    assert out["final_steps"] == steps
    assert out["results"] == port_worker.session_expected(operands, steps)


# -- the link's fail() aborts the sessions of its ranks --------------------------


def test_link_fail_aborts_the_sessions_of_its_ranks():
    """``DeviceLink.fail`` calls ``abort_sessions_for_devices`` with the
    link's ranks (a multi-controller link's two; a link inside one process
    has none and aborts nothing)."""
    from incubator_brpc_tpu_torch.transport.device_link import DeviceLink

    hit = port_mcd._register_session("over-the-link", [3, 5], 0.0)
    other = port_mcd._register_session("elsewhere", [1, 2], 0.0)
    try:
        local = DeviceLink(["cpu", "cpu"], slot_words=64, window=2)
        local.fail("test")
        assert not hit.abort_event.is_set()
        link = DeviceLink(["cpu", "cpu"], slot_words=64, window=2)
        link.ranks = (5, 7)
        link.fail("peer gone")
        assert hit.abort_event.is_set() and "device link failed: peer gone" in hit.abort_reason
        assert not other.abort_event.is_set()
    finally:
        port_mcd._unregister_session(hit)
        port_mcd._unregister_session(other)
