"""The port's collective session plane (``parallel/mc_dispatch.py``,
``mc_collective.py``, ``quantized.py``) against the JAX package's, on the
CPU: ``incubator_brpc_tpu.parallel.mc_dispatch.run_dispatch_session`` on the
conftest's virtual CPU devices (its single-controller form) and the port's
with ``device="cpu"`` (the kernels' plain versions), on the same operands.

Tolerances: the integer ``_scale_psum_kernel`` chains byte for byte under
every schedule; quantized pmean bitwise at 2 parties and within 1e-5 at 3
(XLA may add the parties in another order; the port adds them in party
order and equals the numpy model ``np_quantized_pmean`` bitwise); the exact
pmean within 1e-5 of ``expected_mean``. Resume, reshard and quantized
rings are held byte for byte against the undisturbed run, as
``tests/test_robustness.py`` and ``tests/test_quantized.py`` hold the JAX
package's.
"""

import base64
import threading
import time

import jax
import numpy as np
import pytest
import torch

from incubator_brpc_tpu.parallel import mc_collective as jax_mcc
from incubator_brpc_tpu.parallel import mc_dispatch as jax_mcd
from incubator_brpc_tpu.rpc.device_method import DeviceMethod as JaxDeviceMethod
from incubator_brpc_tpu.transport import mc_worker as jax_worker
from incubator_brpc_tpu_torch.parallel import mc_collective as mcc
from incubator_brpc_tpu_torch.parallel import mc_dispatch as mcd
from incubator_brpc_tpu_torch.parallel import quantized as Q
from incubator_brpc_tpu_torch.parallel.mesh import party_axis
from incubator_brpc_tpu_torch.rpc.device_method import (
    DeviceMethod,
    lookup_device_method,
    register_device_method,
    unregister_device_method,
)
from incubator_brpc_tpu_torch.transport.mc_worker import (
    SESSION_WIDTH,
    _scale_psum_kernel,
    _scale_psum_kernel_wrong,
    session_expected,
)

WIDTH = 256  # 64 floats = 2 default blocks
# tests/test_overlap.py TestChunkedSessions: (chunks, double_buffer)
SCHEDULES = [(1, False), (4, False), (4, True), (1, True), (8, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These sizes gain nothing from threads; one keeps the xdist workers'
    cores for the timing-sensitive tests running beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_thread_left():
    yield
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def _rows(n, nfloats, seed=5, scale=3.0):
    rng = np.random.default_rng(seed)
    return [
        (rng.standard_normal(nfloats) * scale * (i + 1)).astype(np.float32)
        for i in range(n)
    ]


def _jax_ids(n):
    return [d.id for d in jax.devices()[:n]]


def _port(dm, ops, steps, own=0, **kw):
    row, n, _ = mcd.run_dispatch_session(
        list(range(len(ops))), own, dm, ops, steps, device="cpu", **kw
    )
    return bytes(row[:n])


def _jax(dm, ops, steps, own=0, **kw):
    row, n, _ = jax_mcd.run_dispatch_session(_jax_ids(len(ops)), own, dm, ops, steps, **kw)
    return bytes(np.asarray(row[:n], np.uint8))


def _floats(raw):
    return np.frombuffer(raw, np.float32)


# -- integer chains: byte for byte with the JAX package ------------------------


@pytest.mark.parametrize("steps", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("chunks,double_buffer", SCHEDULES)
def test_scale_psum_chain_matches_jax(steps, chunks, double_buffer):
    ops = [bytes(range(40)), bytes(range(100, 180)), bytes([7]) * 300]
    kw = dict(chunks=chunks, double_buffer=double_buffer)
    port_dm = DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH, chunkable=True)
    jax_dm = JaxDeviceMethod(jax_worker._scale_psum_kernel, width=SESSION_WIDTH, chunkable=True)
    want = session_expected(ops, steps)
    for own in (0, 2):
        got = _port(port_dm, ops, steps, own, **kw)
        assert got == _jax(jax_dm, ops, steps, own, **kw) == want[own]


def test_chunk_order_and_counters():
    ops = [b"\x05" * 16, b"\x09" * 24]
    dm = DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH, chunkable=True)
    c0, s0, st0 = (mcd.dispatch_chunks.get_value(), mcd.dispatch_sessions.get_value(),
                   mcd.dispatch_steps.get_value())
    m0 = mcd._method_counter("dsvc", "scale").get_value()
    assert _port(dm, ops, 2, service="dsvc", method="scale") == session_expected(ops, 2)[0]
    assert mcd.dispatch_chunks.get_value() == c0  # the unchunked chain
    routed = _port(dm, ops, 2, chunks=4, double_buffer=True, chunk_order=[3, 1, 0, 2],
                   service="dsvc", method="scale")
    assert routed == session_expected(ops, 2)[0]
    assert mcd.dispatch_chunks.get_value() == c0 + 2 * 4  # steps x chunks
    assert mcd.dispatch_sessions.get_value() == s0 + 2
    assert mcd.dispatch_steps.get_value() == st0 + 4
    assert mcd._method_counter("dsvc", "scale").get_value() == m0 + 2
    assert 0.0 <= mcd.overlap_ratio_gauge.get_value() <= 1.0
    with pytest.raises(ValueError, match="permutation"):
        _port(dm, ops, 2, chunks=4, chunk_order=[0, 0, 1, 2])


def test_admission_rejects_before_any_step():
    ops = [b"\x01" * 8] * 2
    plain = DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH)
    with pytest.raises(ValueError, match="not registered chunkable"):
        _port(plain, ops, 2, chunks=2)
    with pytest.raises(ValueError, match="does not divide"):
        _port(DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH, chunkable=True), ops, 2,
              chunks=3)
    with pytest.raises(ValueError, match="no int8 quantized variant"):
        _port(plain, ops, 2, quantize="int8")
    with pytest.raises(ValueError, match="one operand per party"):
        mcd.run_dispatch_session([0, 1, 2], 0, plain, ops, 2, device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        mcd.run_dispatch_session([4, 4], 0, plain, ops, 2, device="cpu")
    with pytest.raises(ValueError, match="resume_from"):
        _port(plain, ops, 2, resume_from=3)
    with pytest.raises(ValueError, match="exceeds"):
        _port(plain, [b"\x01" * (SESSION_WIDTH + 1)] * 2, 1)


def test_party_axis():
    axis = party_axis(3, "cpu")
    t = torch.arange(12, dtype=torch.int32).view(3, 4)
    assert axis.all_gather(t) is t
    assert torch.equal(axis.psum(t), t.sum(0).expand(3, 4))
    with pytest.raises(ValueError, match="parties on dim 0"):
        axis.psum(t[:2])
    with pytest.raises(ValueError, match="on cpu"):
        party_axis(3, "cpu").psum(torch.zeros(3, 4, device="meta"))
    if not torch.cuda.is_available():  # no card: the default device refuses
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            party_axis(2)


def test_fingerprint_distinguishes_kernel_bodies():
    a = DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH)
    b = DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH)
    c = DeviceMethod(_scale_psum_kernel_wrong, width=SESSION_WIDTH)
    d = DeviceMethod(_scale_psum_kernel, width=2 * SESSION_WIDTH)
    assert a.fingerprint() == b.fingerprint()
    assert len({a.fingerprint(), c.fingerprint(), d.fingerprint()}) == 3


def test_resolution_prefers_the_registry():
    dm = DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH)
    assert mcd.resolve_method("dsvc", "scale") is None
    register_device_method("dsvc", "scale", dm)
    try:
        assert mcd.resolve_method("dsvc", "scale") is dm
        assert mcd.resolve_method("dsvc", "scale", SESSION_WIDTH + 4) is None
        from incubator_brpc_tpu_torch.rpc.device_method import registry_fingerprints

        assert registry_fingerprints()["dsvc.scale"] == dm.fingerprint()
    finally:
        unregister_device_method("dsvc", "scale")
    assert lookup_device_method("dsvc", "scale") is None
    pm = mcd.resolve_method(mcc.PMEAN_SERVICE, mcc.PMEAN_METHOD, WIDTH)
    assert pm is mcc._pmean_dm(WIDTH) and pm.quantized("int4").quant_mode == "int4"
    assert mcd.resolve_method(mcc.PMEAN_SERVICE, mcc.PMEAN_METHOD, 30) is None


# -- pmean, exact and quantized -------------------------------------------------


@pytest.mark.parametrize("parties", [2, 3])
def test_collective_session_matches_expected_mean(parties):
    got, _ = mcc.run_collective_session(list(range(parties)), 0, 3, 64, seed=4, device="cpu")
    want = mcc.expected_mean(4, parties, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jgot, _ = jax_mcc.run_collective_session(_jax_ids(parties), 0, 3, 64, seed=4)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=1e-5)
    assert jax_mcc.expected_mean(4, parties, 64).tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("parties", [2, 3])
@pytest.mark.parametrize("chunks,double_buffer", [(1, False), (2, True)])
def test_quantized_pmean_matches_jax(mode, parties, chunks, double_buffer):
    rows = _rows(parties, WIDTH // 4, seed=7 + parties)
    ops = [r.tobytes() for r in rows]
    kw = dict(quantize=mode, chunks=chunks, double_buffer=double_buffer)
    got = _port(mcc._pmean_dm(WIDTH), ops, 2, **kw)
    want = _jax(jax_mcc._pmean_dm(WIDTH), ops, 2, **kw)
    if parties == 2:
        assert got == want
    else:
        np.testing.assert_allclose(_floats(got), _floats(want), rtol=0, atol=1e-5)
    assert got == Q.np_quantized_pmean(rows, 2, mode).tobytes()
    exact = _floats(_port(mcc._pmean_dm(WIDTH), ops, 2))
    assert float(np.abs(_floats(got) - exact).max()) <= Q.pmean_error_bound(rows, 2, mode)
    assert _port(mcc._pmean_dm(WIDTH), ops, 2, own=parties - 1, **kw) == got


def test_quantized_overlap_composes_byte_identically():
    rows = _rows(3, WIDTH // 4, seed=10)
    ops = [r.tobytes() for r in rows]
    dm = mcc._pmean_dm(WIDTH)
    base = _port(dm, ops, 2, quantize="int8")
    assert _port(dm, ops, 2, quantize="int8", chunks=2, double_buffer=True) == base
    assert _port(dm, ops, 2, quantize="int8", chunks=2, chunk_order=[1, 0]) == base


def test_quantized_bvars_and_wire_accounting():
    rows = _rows(3, WIDTH // 4, seed=13)
    q0 = mcd.dispatch_quantized_sessions.get_value()
    s0 = mcd.dispatch_bytes_saved.get_value()
    _port(mcc._pmean_dm(WIDTH), [r.tobytes() for r in rows], 2, quantize="int8")
    assert mcd.dispatch_quantized_sessions.get_value() == q0 + 1
    assert mcd.dispatch_bytes_saved.get_value() - s0 == (WIDTH - Q.wire_bytes(WIDTH, "int8")) * 3 * 2


def test_misaligned_chunks_and_nonchunkable_variant_reject():
    """tests/test_quantized.py:296-325: a chunk split that cuts a scale
    block, and a variant registered without chunk-safety, are refused at
    admission."""
    v8 = mcc._pmean_dm(WIDTH).quantized("int8")
    with pytest.raises(ValueError, match="block alignment"):
        mcd._validate_chunks(v8, 4, "_collective", "pmean")
    base = DeviceMethod(Q._make_quantized_pmean_kernel("int8", 32), width=WIDTH, chunkable=True)
    bad = DeviceMethod(Q._make_quantized_pmean_kernel("int8", 32), width=WIDTH, chunkable=False)
    bad.quant_mode = "int8"
    base.quant_variants["int8"] = bad
    with pytest.raises(ValueError, match="not registered chunkable"):
        mcd._validate_chunks(base.quantized("int8"), 2, "svc", "m")


# -- checkpoint rings, resume and reshard (tests/test_robustness.py:2025-2158) --


def _scale_dm():
    return DeviceMethod(_scale_psum_kernel, width=SESSION_WIDTH)


def test_resume_replays_only_steps_past_checkpoint():
    ops = [bytes([i + 1]) * 16 for i in range(3)]
    dm, sid = _scale_dm(), "t-torch-resume"
    try:
        _port(dm, ops, 6, session_id=sid, checkpoint_every=2)
        assert mcd.checkpoint_watermarks(sid)[0]["watermark"] == 6
        assert mcd.checkpoint_watermarks(sid)[0]["steps"] == [2, 4, 6]
        before = mcd.dispatch_steps.get_value()
        got = _port(dm, ops, 12, session_id=sid, resume_from=6, checkpoint_every=2)
        assert mcd.dispatch_steps.get_value() - before == 6
        assert got == session_expected(ops, 12)[0]
    finally:
        mcd.release_checkpoints(sid)


def test_resume_point_equal_to_final_replays_nothing():
    ops = [b"\x05" * 8, b"\x06" * 8, b"\x07" * 8]
    dm, sid = _scale_dm(), "t-torch-resume-final"
    try:
        _port(dm, ops, 4, session_id=sid, checkpoint_every=2)
        before = mcd.dispatch_steps.get_value()
        assert _port(dm, ops, 4, session_id=sid, resume_from=4) == session_expected(ops, 4)[0]
        assert mcd.dispatch_steps.get_value() - before == 0
    finally:
        mcd.release_checkpoints(sid)


def test_replacement_reshard_round_trip():
    """checkpoint_fetch's b64 rows restore a session with no local ring,
    a new label in slot 0, and the replayed chain lands byte-identical."""
    ops = [bytes([7 * i + 1]) * 12 for i in range(3)]
    dm, sid = _scale_dm(), "t-torch-reshard"
    pids = [10, 11, 12]
    try:
        mcd.run_dispatch_session(pids, 0, dm, ops, 4, session_id=sid, checkpoint_every=2,
                                 device="cpu")
        rows = mcd.checkpoint_fetch(sid, 4, [0, 1, 2])
        assert set(rows) == {0, 1, 2}
        state = {i: (base64.b64decode(v["row"]), int(v["n"])) for i, v in rows.items()}
        assert all(len(r) == SESSION_WIDTH for r, _n in state.values())
        row, n, _ = mcd.run_dispatch_session(
            [13] + pids[1:], 1, dm, ops, 8, session_id="t-torch-reshard-2",
            resume_from=4, resume_state=state, device="cpu",
        )
        assert bytes(row[:n]) == session_expected(ops, 8)[1]
        # a wrong-geometry reshard row is unrecoverable
        state[0] = (state[0][0][:-1], state[0][1])
        with pytest.raises(LookupError):
            mcd.run_dispatch_session([13] + pids[1:], 1, dm, ops, 8, session_id="t-none",
                                     resume_from=4, resume_state=state, device="cpu")
    finally:
        mcd.release_checkpoints(sid)
        mcd.release_checkpoints("t-torch-reshard-2")


def test_missing_checkpoint_raises_lookup_error():
    with pytest.raises(LookupError):
        _port(_scale_dm(), [b"\x01" * 8] * 3, 8, session_id="t-torch-no-ring", resume_from=4)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("chunks", [1, 2])
def test_quantized_ring_shrinks_and_resumes_byte_identically(mode, chunks):
    rows = _rows(3, WIDTH // 4, seed=14)
    ops = [r.tobytes() for r in rows]
    dm, sid = mcc._pmean_dm(WIDTH), f"t-torch-qring-{mode}-{chunks}"
    try:
        full = _port(dm, ops, 4, quantize=mode, session_id=sid, checkpoint_every=2,
                     chunks=chunks)
        ring = mcd._checkpoint_lookup(sid, 0)
        assert ring is not None and ring.watermark() == 4
        assert ring.entry_bytes == 3 * (Q.wire_bytes(WIDTH, mode) + 4)
        assert mcd.checkpoint_bytes_retained() >= 2 * ring.entry_bytes
        assert mcd.checkpoint_bytes_gauge.get_value() == mcd.checkpoint_bytes_retained()
        entry = ring.get(2)
        assert entry is not None and isinstance(entry[0], mcd._QuantCk)
        resumed = _port(dm.quantized(mode), ops, 4, session_id=sid, resume_from=2,
                        checkpoint_every=2, chunks=chunks)
        assert resumed == full
        fetched = mcd.checkpoint_fetch(sid, 2, [0, 1, 2])
        for info in fetched.values():
            raw = base64.b64decode(info["row"])
            assert len(raw) == WIDTH and np.isfinite(np.frombuffer(raw, np.float32)).all()
    finally:
        mcd.release_checkpoints(sid)


def test_ring_depth_eviction_and_resume_point():
    sids = [f"t-torch-ring-cap-{i}" for i in range(mcd._MAX_CHECKPOINT_SESSIONS + 2)]
    for sid in sids:
        mcd._checkpoint_ring(sid, 0, (1,), entry_bytes=1)
    assert not mcd.checkpoint_watermarks(sids[0])  # evicted
    assert mcd._checkpoint_lookup(sids[-1], 0) is not None
    for sid in sids:
        mcd.release_checkpoints(sid)
    assert mcd.resume_point({0: {"watermark": 6, "steps": [4, 6]},
                             1: {"watermark": 4, "steps": [2, 4]}}) == 4
    assert mcd.resume_point({0: {"watermark": 6, "steps": [6]}, 1: None}) == 0
    assert mcd.resume_point({0: {"watermark": 6, "steps": [2, 6]},
                             1: {"watermark": 4, "steps": [2]}}) == 2


@pytest.mark.parametrize("name", [
    "mc_dispatch_min_steps", "mc_dispatch_session_deadline_ms", "mc_dispatch_checkpoint_every",
    "mc_dispatch_checkpoint_depth", "mc_dispatch_step_deadline_ms",
])
def test_flags_match_the_jax_package(name):
    from incubator_brpc_tpu.utils import flags as jax_flags
    from incubator_brpc_tpu_torch.utils import flags

    assert flags.get_flag(name) == jax_flags.get_flag(name)
    assert not flags.set_flag(name, -1)  # the validators refuse what JAX's refuse
    assert flags.get_flag(name) == jax_flags.get_flag(name)


def test_checkpoint_depth_flag_bounds_the_ring():
    from incubator_brpc_tpu_torch.utils import flags

    ops = [b"\x04" * 8] * 2
    sid = "t-torch-depth"
    assert flags.set_flag("mc_dispatch_checkpoint_depth", 2)
    try:
        _port(_scale_dm(), ops, 8, session_id=sid, checkpoint_every=2)
        assert mcd.checkpoint_watermarks(sid)[0]["steps"] == [6, 8]
    finally:
        flags.set_flag("mc_dispatch_checkpoint_depth", 4)
        mcd.release_checkpoints(sid)


# -- the fault plane ------------------------------------------------------------


def test_should_abort_raises_session_aborted():
    ops = [b"\x02" * 8] * 2
    dm = _scale_dm()
    seen = []

    def hook(step):
        seen.append(step)

    s0 = mcd.dispatch_sessions.get_value()
    mcd.set_step_hook(hook)
    try:
        with pytest.raises(mcd.SessionAborted) as ei:
            _port(dm, ops, 6, should_abort=lambda: "peer died" if len(seen) >= 3 else None)
    finally:
        mcd.set_step_hook(None)
    assert ei.value.error_code == 4005 and ei.value.reason == "peer died"
    assert seen == [0, 1, 2]
    assert mcd.dispatch_sessions.get_value() == s0  # an aborted session is no session


def test_abort_session_and_the_step_watchdog():
    ops = [b"\x03" * 8] * 2
    dm, sid = _scale_dm(), "t-torch-watchdog"
    st = mcd._register_session(sid, [0, 1], deadline=0)
    a0 = mcd.dispatch_aborts.get_value()
    mcd.set_step_hook(lambda step: time.sleep(0.3) if step == 1 else None)
    try:
        with pytest.raises(mcd.SessionAborted, match="step 1 exceeded the 50ms step deadline"):
            _port(dm, ops, 4, session_id=sid, step_deadline_ms=50,
                  should_abort=lambda: st.abort_reason if st.aborted else None)
    finally:
        mcd.set_step_hook(None)
        mcd._unregister_session(st)
    assert mcd.dispatch_aborts.get_value() == a0 + 1
    assert mcd.aborted_epoch(sid) == 0
    assert mcd.active_sessions() == 0
    assert mcd.abort_session(sid, "again") is False  # nothing registered now
    # a healthy session under a generous step deadline runs to the end
    assert _port(dm, ops, 3, session_id="t-torch-wd-ok", step_deadline_ms=5000) == \
        session_expected(ops, 3)[0]
