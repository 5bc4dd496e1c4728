"""DeviceEndpoint of the port, on the CPU: the cases of
tests/test_device_transport.py (buckets, credit window, mixed methods in
one batch, per-row ENOMETHOD, an oversized payload, server_handler with the
port's Controller and behind the port's Server, as
test_server_handler_integration runs it), and one parity case against the
JAX package's DeviceEndpoint."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_brpc_tpu.models.tensor_echo import TensorEchoService as JaxService
from incubator_brpc_tpu.transport.device import DeviceEndpoint as JaxEndpoint
from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService
from incubator_brpc_tpu_torch.ops import kernels
from incubator_brpc_tpu_torch.rpc import Channel, Controller, Server, shutdown_host_plane
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport.device import (
    MAX_BUCKET_WORDS,
    DeviceEndpoint,
    _bucket_words,
)
from incubator_brpc_tpu_torch.utils.status import ErrorCode


_OPEN = []  # every endpoint these tests built
_SERVERS = []  # every port Server these tests started


def _endpoint(*args, **kw):
    ep = DeviceEndpoint(*args, **kw)
    _OPEN.append(ep)
    return ep


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    """Stop every server, close every endpoint, end the host plane's
    threads, the completion watchers and the timer, and check that no
    thread of the port is left in this (xdist worker) process."""
    yield
    while _SERVERS:
        srv = _SERVERS.pop()
        srv.stop()
        assert srv.join(timeout=30)
    for ep in _OPEN:
        assert ep.close(timeout=60)
    shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def _mixed_service():
    svc = TensorEchoService()
    svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
    svc.add_method(5, lambda p: kernels.bits32(kernels.u64(p) + 10))
    return svc


def _run_threads(n, fn):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()


def test_power_of_two_buckets():
    assert _bucket_words(1) == 64
    assert _bucket_words(64) == 64
    assert _bucket_words(65) == 128
    assert _bucket_words(1000) == 1024
    assert _bucket_words(1 << 24) == MAX_BUCKET_WORDS
    with pytest.raises(ValueError):
        _bucket_words((1 << 24) + 1)


@pytest.fixture(scope="module")
def endpoint():
    return _endpoint(window_size=4, device="cpu")


class TestDeviceCalls:
    def test_word_echo_roundtrip(self, endpoint):
        words = np.arange(100, dtype=np.uint32)
        pending = endpoint.call_words(words, correlation_id=7)
        assert pending.wait(timeout=30)
        assert pending.error_code == 0
        np.testing.assert_array_equal(pending.response_words, words)

    def test_byte_echo_roundtrip(self, endpoint):
        payload = b"device-transport-payload!"  # not word-aligned
        assert endpoint.call_bytes(payload, timeout=30) == (0, payload)

    def test_unknown_method_is_enomethod(self, endpoint):
        code, _ = endpoint.call_bytes(b"xxxx", method_id=999, timeout=30)
        assert code == ErrorCode.ENOMETHOD

    def test_pipelined_calls_within_window(self, endpoint):
        pendings = [
            endpoint.call_words(np.full(32, i, dtype=np.uint32), correlation_id=i + 1)
            for i in range(4)
        ]
        for i, p in enumerate(pendings):
            assert p.wait(timeout=30)
            assert p.error_code == 0
            assert p.response_words[0] == i

    def test_oversized_payload_is_erequest_and_returns_its_credit(self, endpoint):
        words = np.zeros(MAX_BUCKET_WORDS + 1, dtype=np.uint32)
        pending = endpoint.call_words(words, timeout=30)
        assert pending.wait(timeout=1)
        assert pending.error_code == ErrorCode.EREQUEST
        assert endpoint.inflight == 0

    def test_credit_window_bounds_inflight(self):
        ep = _endpoint(window_size=2, device="cpu")
        results, peak = [], []
        lock = threading.Lock()

        def caller(i):
            peak.append(ep.inflight)
            code, out = ep.call_bytes(b"abcd" * 8, timeout=30)
            with lock:
                results.append((code, out))

        _run_threads(8, caller)
        assert results == [(0, b"abcd" * 8)] * 8  # window stalls, nothing fails
        assert max(peak) <= 2
        assert ep.inflight == 0  # every credit returned

    def test_server_handler_with_stand_in_controller(self, endpoint):
        """The handler called directly with the port's server-side
        Controller (which took the stand-in's place): ``call_id`` in,
        ``set_failed`` out."""
        handler = endpoint.server_handler()
        cntl = Controller(timeout_ms=0)
        cntl.call_id = 42
        assert handler(cntl, b"rpc-over-device-memory") == b"rpc-over-device-memory"
        assert cntl.ok()
        bad = Controller(timeout_ms=0)
        assert endpoint.server_handler(method_id=999)(bad, b"abcd") == b""
        assert bad.error_code == ErrorCode.ENOMETHOD
        assert bad.error_text == f"device call failed ({int(ErrorCode.ENOMETHOD)})"

    def test_server_handler_integration(self, endpoint):
        """Host RPC -> device step -> response: a port Channel calls the
        handler mounted on a port Server (tests/test_device_transport.py
        test_server_handler_integration, on the port)."""
        server = Server()
        server.add_service("tensor", {
            "echo": endpoint.server_handler(),
            "unknown": endpoint.server_handler(method_id=999),
        })
        assert server.start(0)
        _SERVERS.append(server)
        ch = Channel()
        assert ch.init(f"127.0.0.1:{server.port}")
        cntl = ch.call_method("tensor", "echo", b"rpc-over-hbm", cntl=None)
        assert cntl.ok(), cntl.error_text
        assert cntl.response_payload == b"rpc-over-hbm"
        cntl = ch.call_method("tensor", "unknown", b"abcd")
        assert cntl.error_code == ErrorCode.ENOMETHOD


class TestBatchedDispatch:
    def test_mixed_methods_in_one_batch(self):
        ep = _endpoint(service=_mixed_service(), device="cpu", window_size=32, max_batch=16)
        ep.warm(64)
        results = {}

        def worker(i):
            mid = (0, 3, 5)[i % 3]
            pending = ep.call_words(
                np.full(16, i + 1, dtype=np.uint32), method_id=mid,
                correlation_id=i + 1, timeout=60,
            )
            assert pending.wait(60)
            results[i] = (mid, pending.error_code, pending.response_words)

        _run_threads(18, worker)
        assert len(results) == 18
        for i, (mid, code, words) in results.items():
            assert code == 0, (i, code)
            want = {0: i + 1, 3: (i + 1) * 2, 5: i + 11}[mid]
            assert (words == want).all(), (i, mid, words[:4])

    def test_unknown_method_in_batch_errors_only_its_row(self):
        ep = _endpoint(device="cpu", window_size=16, max_batch=8)
        ep.warm(32)
        results = {}

        def worker(i):
            mid = 999 if i == 3 else 0
            results[i] = ep.call_bytes(
                b"row%02d" % i, method_id=mid, correlation_id=i + 1, timeout=60
            )

        _run_threads(8, worker)
        for i, (code, out) in results.items():
            if i == 3:
                assert code == ErrorCode.ENOMETHOD, (i, code)
            else:
                assert code == 0 and out == b"row%02d" % i, (i, code)


def test_mixed_batch_matches_jax_endpoint():
    """The same 18 concurrent mixed-method calls (methods 0, 3, 5 and an
    unknown 999) through the JAX DeviceEndpoint and the port's give
    identical words and codes."""
    jsvc = JaxService()
    jsvc.add_method(3, lambda p: p * jnp.uint32(2))
    jsvc.add_method(5, lambda p: p + jnp.uint32(10))
    endpoints = {
        "jax": JaxEndpoint(service=jsvc, window_size=32, max_batch=16),
        "torch": _endpoint(service=_mixed_service(), device="cpu",
                           window_size=32, max_batch=16),
    }
    rng = np.random.default_rng(2024)
    payloads = [
        rng.integers(0, 1 << 32, size=int(rng.integers(1, 200)), dtype=np.uint64).astype(np.uint32)
        for _ in range(18)
    ]
    mids = [999 if i == 7 else (0, 3, 5)[i % 3] for i in range(18)]
    seen = {}
    for name, ep in endpoints.items():
        ep.warm(4 * 256)
        out = {}

        def worker(i, ep=ep, out=out):
            pending = ep.call_words(payloads[i], method_id=mids[i], correlation_id=i + 1, timeout=120)
            assert pending.wait(120)
            words = pending.response_words
            out[i] = (int(pending.error_code), None if words is None else np.array(words))

        _run_threads(18, worker)
        seen[name] = out
    for i in range(18):
        jcode, jwords = seen["jax"][i]
        tcode, twords = seen["torch"][i]
        assert tcode == jcode, (i, mids[i])
        np.testing.assert_array_equal(twords, jwords)
    assert seen["torch"][7][0] == ErrorCode.ENOMETHOD


def test_endpoint_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceEndpoint()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceEndpoint(device="cuda")
    assert _endpoint(device="cpu").device.type == "cpu"
