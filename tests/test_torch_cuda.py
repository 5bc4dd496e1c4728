"""The port's CUDA kernels and endpoint on the card: each K1 kernel against
its plain version, bit for bit, the endpoint's calls answered through the
kernels, K3 (the ring-attention fold and its gradient, on the tensor cores
for bf16 at any D up to 1024 and in any layout; the f32 fold, dK/dV and dQ
in 3xTF32 on them too, within chip_smoke.py's f32 tolerance) against its
plain versions within the tolerances of ``chip_smoke.py`` (``attn_bwd_delta``
in both forms, vector and general, at D 4 to 4096, any row count, copied
and misaligned inputs and past 2^31 elements, each launch in the form
``delta_form`` names and a vector launch off its alignments refused), K4 (the residual
add and RMS norm, on both sides of the rows it keeps in registers, within
``NORM_TOL``; the norm's backward, the tanh GeLU and its backward bit for
bit, but for elements within ``TRANSCENDENTAL_ULPS`` that pass through
tanhf) against its plain versions, K4f (the heads = 0 ring mean, forward
and gradient, at sp 1 and over the sp ring) bit for bit against its plain
versions, one FabricNet train step on the card against the CPU with heads 2
and with heads 0, one step on the {pp2 sp2 ep2} mesh (8 ranks on the card)
against the same step with every plain version, K2 (block quantize and dequantize-mean)
against its plain versions and the numpy twin bit for bit on
``chip_smoke.py``'s rows, in each form (vector and general) with the form
each launch took asserted, one quantized session on the card against the
same session on the CPU, byte for byte, and K4e (the SGD update bit for bit
against its plain version; the MoE's gate and combine bit for bit but for
elements within ``TRANSCENDENTAL_ULPS`` that pass through expf; the loss
within ``MSE_TOL``) with the sliced schedules on the card against the CPU. Marked ``gpu``; each test skips
where PyTorch sees no CUDA card.

The endpoint is also driven as device RPC through the port's Server and
Channel, over TCP and over the two-party device link (``transport="tpu"``),
whose forced device form streams through the card in both ack modes; and
``device_method()`` around the quantized pmean kernel answers the numpy
twin's bytes on the card; a PartitionChannel over four servers of that
device method answers four copies of them with four K2a and K2b launches a
fan-out, and an ``rr`` LB channel over three servers' links rotates across
every peer. Streaming RPC carries chip_smoke.py's seeded messages in order
over TCP and over the forced device form of a link on the card, and the
two-process pair of ``transport/mc_worker.py`` on cuda:0 over gloo keeps its
slot rows on the card, answers device RPC over the multi-controller link
with K1 launched in the server process, and both link halves agree on one
final step count. This file imports no JAX, so on a card machine without JAX it runs with

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from incubator_brpc_tpu_torch.models import fabricnet
from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService, make_echo_step
from incubator_brpc_tpu_torch.ops import attention, elementwise, framing, kernels, quantize, update
from incubator_brpc_tpu_torch.parallel import mc_collective, mc_dispatch
from incubator_brpc_tpu_torch.parallel import quantized as Q
from incubator_brpc_tpu_torch.parallel.mesh import make_fabric_mesh
from incubator_brpc_tpu_torch.transport.device import DeviceEndpoint

pytestmark = pytest.mark.gpu

K1 = ("frame_rows", "verify_rows", "echo_step_rows")
# the K3 kernels each operand dtype launches: the fold, dK/dV and dQ follow
# the dtype (tensor cores for bf16), delta takes both
FOLD = {torch.float32: "attn_fold_fwd_tf32", torch.bfloat16: "attn_fold_fwd_tc"}
DKDV = {torch.float32: "attn_bwd_dkdv_tf32", torch.bfloat16: "attn_bwd_dkdv_tc"}
DQ = {torch.float32: "attn_bwd_dq_tf32", torch.bfloat16: "attn_bwd_dq_tc"}
K3_BOTH = ("attn_bwd_delta",)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _words(gen, shape, dev):
    t = torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=gen, device=dev)
    return kernels.bits32(t).view(torch.uint32)


def _requests(gen, rows, words, dev):
    """Rows cycling: valid, bad magic, bad length, flipped word, method 999."""
    payload = _words(gen, (rows, words), dev)
    zeros = torch.zeros(rows, dtype=torch.int32, device=dev).view(torch.uint32)
    framed = kernels.frame_rows_plain(payload, _words(gen, (rows,), dev), zeros)
    v = framed.view(torch.int32)
    for r in range(rows):
        kind = r % 5
        if kind == 1:
            v[r, 0] = 0
        elif kind == 2:
            v[r, 1] = words + 1
        elif kind == 3:
            v[r, 8 + words // 2] = v[r, 8 + words // 2] ^ 1
        elif kind == 4:
            v[r, 5] = 999
    return framed


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("rows,words", [(1, 1), (5, 64), (16, 100), (3, 8192 + 12), (2, 1 << 16)])
def test_kernels_match_plain_versions(cuda, rows, words):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(rows * 100003 + words)
    payload = _words(gen, (rows, words), cuda)
    meta = [_words(gen, (rows,), cuda) for _ in range(4)]
    kw = dict(cid_hi=meta[2], err=meta[3], flags=3)
    before = kernels.launch_counts()
    assert _same(kernels.frame_rows(payload, meta[0], meta[1], **kw),
                 kernels.frame_rows_plain(payload, meta[0], meta[1], **kw))
    framed = _requests(gen, rows, words, cuda)
    assert torch.equal(kernels.verify_rows(framed), kernels.verify_rows_plain(framed))
    assert _same(kernels.echo_step_rows(framed), kernels.echo_step_rows_plain(framed))
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1 for k in K1)


def test_kernels_take_an_unaligned_payload(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    base = _words(gen, (4 * 1001 + 1,), cuda)
    payload = base[1:].view(4, 1001)  # 4-byte aligned, not 16-byte aligned
    cid, mid = _words(gen, (4,), cuda), _words(gen, (4,), cuda)
    assert _same(kernels.frame_rows(payload, cid, mid), kernels.frame_rows_plain(payload, cid, mid))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rows = torch.zeros((4, 72), dtype=torch.int32, device=cuda).view(torch.uint32)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.verify_rows(rows[:, :40])
    with pytest.raises(ValueError):
        kernels.frame_rows(rows[:, 8:].contiguous(), rows[:, 0].contiguous().cpu(), rows[:, 1].contiguous())


def test_endpoint_on_the_card(cuda):
    svc = TensorEchoService()
    svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
    ep = DeviceEndpoint(service=svc, window_size=8, max_batch=8)
    ep.warm(256)
    words = np.arange(100, dtype=np.uint32) + np.uint32(0xFFFFFF00)
    pendings = [ep.call_words(words, method_id=m, correlation_id=i + 1)
                for i, m in enumerate((0, 3, 999, 0))]
    for p in pendings:
        assert p.wait(60)
    assert pendings[0].error_code == 0
    np.testing.assert_array_equal(pendings[0].response_words, words)
    np.testing.assert_array_equal(
        pendings[1].response_words, ((words.astype(np.uint64) * 2) & 0xFFFFFFFF).astype(np.uint32)
    )
    assert pendings[2].error_code == 1002
    assert ep.inflight == 0
    other = DeviceEndpoint()
    assert other.call_bytes(b"echo through K1c") == (0, b"echo through K1c")
    assert ep.close() and other.close()


def test_device_rpc_through_the_port_server_on_the_card(cuda):
    """server_handler() on the port's Server, called through the port's
    Channel: the echo table launches K1a and K1c, the mixed table K1b too,
    and every answer and code is the one the endpoint gives."""
    from incubator_brpc_tpu_torch.rpc import Channel, Server, shutdown_host_plane

    svc = TensorEchoService()
    svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
    echo_ep = DeviceEndpoint(window_size=16)
    mixed_ep = DeviceEndpoint(service=svc, window_size=16)
    server = Server()
    server.add_service("tensor", {"echo": echo_ep.server_handler(),
                                  "x2": mixed_ep.server_handler(method_id=3),
                                  "unknown": mixed_ep.server_handler(method_id=999)})
    assert server.start(0)
    try:
        ch = Channel()
        ch.init(f"127.0.0.1:{server.port}")
        words = np.arange(100, dtype=np.uint32) + np.uint32(0xFFFFFF00)
        kernels.reset_launch_counts()
        cntl = ch.call_method("tensor", "echo", words.tobytes())
        assert cntl.ok() and cntl.response_payload == words.tobytes()
        cntl = ch.call_method("tensor", "x2", words.tobytes())
        want = ((words.astype(np.uint64) * 2) & 0xFFFFFFFF).astype(np.uint32)
        assert cntl.ok() and cntl.response_payload == want.tobytes()
        cntl = ch.call_method("tensor", "unknown", b"abcd")
        assert cntl.error_code == 1002 and cntl.response_payload == b""
        counts = kernels.launch_counts()
        assert all(counts[name] > 0 for name in K1), counts
    finally:
        server.stop()
        assert server.join(timeout=60)
        assert echo_ep.close() and mixed_ep.close()
        shutdown_host_plane()


@pytest.mark.parametrize("ack_mode", ["local", "wire"])
def test_forced_device_link_form_on_the_card(cuda, ack_mode):
    """DeviceLink([cuda, cuda], host_loopback=False): every step's slots go
    through the card, and the delivered stream is the sent one."""
    from incubator_brpc_tpu_torch.transport import device_link as dl

    dev = torch.device("cuda", 0)
    chunks = chip_smoke.stream_chunks(size=256 << 10, distinct=3)
    total = 16 << 20
    _, sink, link = chip_smoke.link_stream(dl, dev, False, ack_mode, chunks, total, hashed=True,
                                           slot_words=16384, window=4)
    assert link._step is not None and str(dev) in link._streams
    assert sink.nbytes == total and sink.crc == chip_smoke.stream_crc(chunks, total)


def test_device_method_quantized_pmean_on_the_card(cuda):
    """device_method() around the int8 quantized pmean kernel, called on a
    Server's card: each answer is the numpy twin's, K2a and K2b once a call."""
    from incubator_brpc_tpu_torch.rpc import Server, device_method

    quant = Q.quantized_pmean_dm(chip_smoke.QUANT_WIDTH, chip_smoke.QUANT_MODE,
                                 chip_smoke.QUANT_BLOCK)
    handler = device_method(quant.kernel, width=chip_smoke.QUANT_WIDTH, chunkable=True)

    class Cntl:
        _server = Server()

    rng = np.random.default_rng(35)
    reqs = [rng.standard_normal(chip_smoke.QUANT_WIDTH // 4).astype(np.float32).tobytes()
            for _ in range(3)]
    handler(Cntl, reqs[0])
    kernels.reset_launch_counts()
    for req in reqs:
        assert handler(Cntl, req) == chip_smoke.link_device_method_expected(req)
    counts = kernels.launch_counts()
    assert [counts[n] for n in chip_smoke.K2] == [len(reqs)] * 2


def test_device_rpc_over_the_link_on_the_card(cuda):
    """server_handler() on the port's Server, called through
    Channel(transport="tpu"): the link takes the host swap on one card, every
    answer and code is the endpoint's, and K1 launched."""
    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, shutdown_host_plane

    svc = TensorEchoService()
    svc.add_method(3, lambda p: kernels.bits32(kernels.u64(p) * 2))
    echo_ep = DeviceEndpoint(window_size=16)
    ep = DeviceEndpoint(service=svc, window_size=16)
    server = Server()
    server.add_service("tensor", {"echo": echo_ep.server_handler(),
                                  "x2": ep.server_handler(method_id=3),
                                  "unknown": ep.server_handler(method_id=999)})
    assert server.start(0)
    try:
        ch = Channel()
        ch.init(f"127.0.0.1:{server.port}",
                options=ChannelOptions(transport="tpu", timeout_ms=120_000))
        words = np.arange(70000, dtype=np.uint32) + np.uint32(0xFFFFFF00)  # spans 5 slots
        kernels.reset_launch_counts()
        cntl = ch.call_method("tensor", "echo", words.tobytes())
        assert cntl.ok() and cntl.response_payload == words.tobytes()
        cntl = ch.call_method("tensor", "x2", words.tobytes())
        want = ((words.astype(np.uint64) * 2) & 0xFFFFFFFF).astype(np.uint32)
        assert cntl.ok() and cntl.response_payload == want.tobytes()
        cntl = ch.call_method("tensor", "unknown", b"abcd")
        assert cntl.error_code == 1002 and cntl.response_payload == b""
        link = ch._device_sock.link
        assert link._step is None and link.devices == [torch.device("cuda", 0)] * 2
        counts = kernels.launch_counts()
        assert all(counts[name] > 0 for name in K1), counts
    finally:
        server.stop()
        assert server.join(timeout=60)
        assert echo_ep.close() and ep.close()
        shutdown_host_plane()


def test_partition_channel_over_device_method_servers_on_the_card(cuda):
    """A PartitionChannel (list://, tags i/4) over four Servers on the card,
    each serving the quantized pmean device method over its link: each
    merged answer is four copies of the numpy twin's bytes, with four K2a
    and four K2b launches a fan-out."""
    from incubator_brpc_tpu_torch.rpc import (
        ChannelOptions, Controller, PartitionChannel, Server, device_method, shutdown_host_plane,
    )

    quant = Q.quantized_pmean_dm(chip_smoke.QUANT_WIDTH, chip_smoke.QUANT_MODE,
                                 chip_smoke.QUANT_BLOCK)
    servers = []
    for _ in range(4):
        srv = Server()
        srv.add_service("quant", {"pmean": device_method(quant.kernel, width=chip_smoke.QUANT_WIDTH,
                                                         chunkable=True)})
        assert srv.start(0)
        servers.append(srv)
    pc = PartitionChannel()
    try:
        url = "list://" + ",".join(f"127.0.0.1:{s.port} {i}/4" for i, s in enumerate(servers))
        assert pc.init(url, partition_count=4,
                       options=ChannelOptions(transport="tpu", timeout_ms=120_000))
        rng = np.random.default_rng(37)
        reqs = [rng.standard_normal(chip_smoke.QUANT_WIDTH // 4).astype(np.float32).tobytes()
                for _ in range(4)]
        assert pc.call_method("quant", "pmean", reqs[0], cntl=Controller(timeout_ms=120_000)).ok()
        kernels.reset_launch_counts()
        for req in reqs[1:]:
            cntl = pc.call_method("quant", "pmean", req, cntl=Controller(timeout_ms=120_000))
            assert cntl.ok(), cntl.error_text
            assert cntl.response_payload == chip_smoke.link_device_method_expected(req) * 4
        counts = kernels.launch_counts()
        assert [counts[n] for n in chip_smoke.K2] == [4 * (len(reqs) - 1)] * 2
        links = [sub[0]._device_sock.link for sub in pc._subs]
        assert all(link.devices == [torch.device("cuda", 0)] * 2 for link in links)
    finally:
        pc.stop()
        for srv in servers:
            srv.stop()
            assert srv.join(timeout=60)
        shutdown_host_plane()


def test_rr_lb_channel_over_device_links_on_the_card(cuda):
    """Channel.init("list://a,b,c", "rr", transport="tpu") over three Servers
    on the card serving the echo table: 30 calls rotate 10 to each peer,
    every answer echoed, K1a and K1c launched."""
    from incubator_brpc_tpu_torch.rpc import Channel, ChannelOptions, Server, shutdown_host_plane

    eps, servers, calls = [], [], [0, 0, 0]
    for i in range(3):
        ep = DeviceEndpoint(window_size=16)
        handler = ep.server_handler()

        def counted(cntl, req, _i=i, _h=handler):
            calls[_i] += 1
            return _h(cntl, req)

        srv = Server()
        srv.add_service("tensor", {"echo": counted})
        assert srv.start(0)
        eps.append(ep)
        servers.append(srv)
    ch = Channel()
    try:
        assert ch.init("list://" + ",".join(f"127.0.0.1:{s.port}" for s in servers), "rr",
                       ChannelOptions(transport="tpu", timeout_ms=120_000))
        kernels.reset_launch_counts()
        payload = bytes(range(256))
        for _ in range(30):
            cntl = ch.call_method("tensor", "echo", payload)
            assert cntl.ok() and cntl.response_payload == payload, cntl.error_text
        assert calls == [10, 10, 10]
        counts = kernels.launch_counts()
        assert counts["frame_rows"] > 0 and counts["echo_step_rows"] > 0, counts
        assert ch._device_sock.link.devices == [torch.device("cuda", 0)] * 2
    finally:
        if ch._lb is not None:
            ch._lb.stop()
        for srv in servers:
            srv.stop()
            assert srv.join(timeout=60)
        for ep in eps:
            assert ep.close()
        shutdown_host_plane()


def test_make_echo_step_on_the_card(cuda):
    step, request = make_echo_step(payload_words=4096)
    assert request.device.type == "cuda"
    header, payload, ok = framing.parse(step(request))
    assert bool(ok) and int(header.error_code) == 0
    assert _same(payload, request[8:])


def _qkvo(gen, shape, dtype, dev):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(4)]


# (B, T, H, D, sp): a ragged T/sp = 12 at D 16, T/sp = 100 at D 144 (ragged
# against the tensor-core fold's 32-row and 64-key tiles and its 128-column
# D chunks), and the bench attention shape
@pytest.mark.parametrize("shape", [(2, 48, 4, 16, 4), (1, 200, 2, 144, 2), (4, 1024, 2, 1024, 4)],
                         ids=["small", "d144", "d1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_k3_matches_plain_versions(cuda, shape, dtype, causal):
    _k3_against_plain(cuda, shape, dtype, causal)


def _k3_against_plain(cuda, shape, dtype, causal):
    b, t, h, d, sp = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(b * t + d + sp)
    q, k, v, dout = _qkvo(gen, (b, t, h, d), dtype, cuda)
    before = kernels.launch_counts()
    out, lse, (m, l, o) = attention.forward(q, k, v, sp=sp, causal=causal)
    dq, dk, dv = attention.backward(q, k, v, out, dout, lse, sp=sp, causal=causal)
    after = kernels.launch_counts()
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    assert after[FOLD[dtype]] == before[FOLD[dtype]] + sp
    assert after[DKDV[dtype]] == before[DKDV[dtype]] + 1
    assert after[DQ[dtype]] == before[DQ[dtype]] + 1
    assert after[FOLD[other]] == before[FOLD[other]]
    assert after[DKDV[other]] == before[DKDV[other]]
    assert after[DQ[other]] == before[DQ[other]]
    assert all(after[n] == before[n] + 1 for n in K3_BOTH)
    state = None
    for hop in range(sp):
        state = attention.fold_plain(q, k, v, state, hop=hop, sp=sp, causal=causal)
    want_out, want_lse = attention.finalize_plain(state, dtype)
    grads = attention.backward_plain(q, k, v, out, dout, lse, sp=sp, causal=causal)
    # f32: sums in another order; bf16: one rounding of the result to bf16
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    assert out.dtype == dtype
    torch.testing.assert_close(m, state[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(l, state[1], rtol=1e-5, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=tol, atol=tol)
    for got, want in zip((dq, dk, dv), grads):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol * scale)


# every K3 shape above and below: ragged T, sp 4, D off the k-steps, D 18
# through the padding; causal and not
F32_FOLD_SHAPES = [(2, 48, 4, 16, 4), (1, 200, 2, 144, 2), (4, 1024, 2, 1024, 4),
                   (4, 1024, 2, 1024, 1), (2, 72, 2, 24, 2), (2, 72, 2, 20, 2), (2, 72, 2, 18, 2)]


@pytest.mark.parametrize("shape", F32_FOLD_SHAPES,
                         ids=["small", "d144", "d1024-sp4", "d1024", "d24", "d20", "d18"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tf32_fold_holds_the_f32_tolerance(cuda, shape, causal):
    """``attn_fold_fwd_tf32`` (f32 operands, 3xTF32 on the tensor cores)
    against ``fold_plain`` within ``chip_smoke.k3_tolerances``' 2e-5 x
    max(1, max |plain|) on out, m, l, o and lse, as chip_smoke.py holds
    it; one launch a hop, and the CUDA-core fold it replaced is gone."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape) + causal)
    errs = {name: {} for name in chip_smoke.K3}
    before = kernels.launch_counts()
    chip_smoke.k3_case(torch, attention, gen, cuda, shape, torch.float32, causal, errs)
    after = kernels.launch_counts()
    assert after["attn_fold_fwd_tf32"] == before["attn_fold_fwd_tf32"] + shape[-1]
    assert after["attn_fold_fwd_tc"] == before["attn_fold_fwd_tc"]
    assert not any(n in after for n in chip_smoke.REMOVED)


@pytest.mark.parametrize("shape", F32_FOLD_SHAPES,
                         ids=["small", "d144", "d1024-sp4", "d1024", "d24", "d20", "d18"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tf32_dkdv_holds_the_f32_tolerance(cuda, shape, causal):
    """``attn_bwd_dkdv_tf32`` (f32 operands, 3xTF32 on the tensor cores)
    against ``dkdv_plain`` on the same inputs within ``chip_smoke.k3_tolerances``'
    2e-5 x max(1, max |plain|), one launch a call, and the CUDA-core
    ``attn_bwd_dkdv`` it replaced is gone."""
    b, t, h, d, sp = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape) + 2 * causal)
    q, k, v, dout = _qkvo(gen, (b, t, h, d), torch.float32, cuda)
    out, lse, _ = attention.forward(q, k, v, sp=sp, causal=causal)
    delta = attention.row_dot(out, dout)
    before = kernels.launch_counts()
    dk, dv = attention.dkdv(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    after = kernels.launch_counts()
    assert after["attn_bwd_dkdv_tf32"] == before["attn_bwd_dkdv_tf32"] + 1
    assert after["attn_bwd_dkdv_tc"] == before["attn_bwd_dkdv_tc"]
    assert "attn_bwd_dkdv" in chip_smoke.REMOVED and "attn_bwd_dkdv" not in after
    tol = chip_smoke.k3_tolerances(torch)[torch.float32]
    for got, want in zip((dk, dv), attention.dkdv_plain(q, k, v, dout, lse, delta, sp=sp,
                                                        causal=causal)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("shape", F32_FOLD_SHAPES,
                         ids=["small", "d144", "d1024-sp4", "d1024", "d24", "d20", "d18"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tf32_dq_holds_the_f32_tolerance(cuda, shape, causal):
    """``attn_bwd_dq_tf32`` (f32 operands, 3xTF32 on the tensor cores)
    against ``dq_plain`` on the same inputs within ``chip_smoke.k3_tolerances``'
    2e-5 x max(1, max |plain|), one launch a call, and the CUDA-core
    ``attn_bwd_dq`` it replaced is gone."""
    b, t, h, d, sp = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape) + 3 * causal)
    q, k, v, dout = _qkvo(gen, (b, t, h, d), torch.float32, cuda)
    out, lse, _ = attention.forward(q, k, v, sp=sp, causal=causal)
    delta = attention.row_dot(out, dout)
    before = kernels.launch_counts()
    dq = attention.dq(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    after = kernels.launch_counts()
    assert after["attn_bwd_dq_tf32"] == before["attn_bwd_dq_tf32"] + 1
    assert after["attn_bwd_dq_tc"] == before["attn_bwd_dq_tc"]
    assert "attn_bwd_dq" in chip_smoke.REMOVED and "attn_bwd_dq" not in after
    want = attention.dq_plain(q, k, v, dout, lse, delta, sp=sp, causal=causal)
    assert dq.dtype == torch.float32 and dq.shape == want.shape
    tol = chip_smoke.k3_tolerances(torch)[torch.float32]
    assert float((dq - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))


def test_tensor_core_fold_refuses_a_head_dimension_off_its_k_step(cuda):
    """Once a refusal, now a value check: bf16 at D = 24 (16-byte rows, off
    the k-step of 16) and D = 20 (8-byte rows) runs on the tensor-core fold,
    dK/dV and dQ, held against the plain versions; ragged T / sp = 36."""
    for d in (24, 20):
        for causal in (True, False):
            _k3_against_plain(cuda, (2, 72, 2, d, 2), torch.bfloat16, causal)


def test_k3_refuses_head_dimensions_past_its_limits(cuda):
    """D = 1028 is refused, the message naming the limit; D = 18, once
    refused too, is padded to 20 by the wrappers and held against the plain
    versions in bf16 and f32 (ragged T / sp = 36)."""
    before = kernels.launch_counts()
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((1, 8, 1, 1028), dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match="D <= 1024"):
            attention.fold(q, q, q, None, hop=0, sp=1, causal=True, finalize=True)
        lse = torch.zeros((1, 1, 8), device=cuda)
        with pytest.raises(ValueError, match="D <= 1024"):
            attention.dkdv(q, q, q, q, lse, lse, sp=1, causal=True)
        with pytest.raises(ValueError, match="D <= 1024"):
            attention.dq(q, q, q, q, lse, lse, sp=1, causal=True)
    assert kernels.launch_counts() == before
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (True, False):
            _k3_against_plain(cuda, (2, 72, 2, 18, 2), dtype, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k3_takes_any_layout(cuda, dtype):
    """Transposed views, and tensors offset by one element inside a larger
    buffer (not 16-byte aligned), give bitwise what contiguous copies give."""
    b, t, h, d, sp = 2, 96, 2, 136, 2
    gen = torch.Generator(device=cuda)
    gen.manual_seed(61)
    dense = _qkvo(gen, (b, t, h, d), dtype, cuda)

    def run(q, k, v, dout):
        out, lse, _ = attention.forward(q, k, v, sp=sp, causal=True)
        return (out, lse) + attention.backward(q, k, v, out, dout, lse, sp=sp, causal=True)

    def offset(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y

    want = run(*dense)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in dense]
    shifted = [offset(x) for x in dense]
    assert not any(x.is_contiguous() for x in views)
    assert all(x.data_ptr() % 16 for x in shifted)
    for inputs in (views, shifted):
        for got, w in zip(run(*inputs), want):
            assert torch.equal(got, w)


@pytest.mark.parametrize("d", chip_smoke.DELTA_DS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_delta_forms_match_row_dot_plain(cuda, d, dtype):
    """Both forms of ``attn_bwd_delta`` within 2e-5 x max(1, max |plain|) of
    ``row_dot_plain`` on 333 rows (no form's last block full), the launch in
    the form ``delta_form`` names, a vector launch refused off its
    alignments (chip_smoke.delta_case); one launch each."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + (dtype == torch.bfloat16))
    before = kernels.launch_counts()["attn_bwd_delta"]
    form = chip_smoke.delta_case(torch, attention, gen, cuda, d, dtype, {})
    assert form == attention.delta_form(d, dtype, True)
    assert kernels.launch_counts()["attn_bwd_delta"] == before + (2 if form[0] == "vector" else 1)


@pytest.mark.parametrize("rows", [(1, 1, 1), (1, 129, 1), (2, 5, 3)], ids=["1", "129", "30"])
@pytest.mark.parametrize("d,dtype", [(16, torch.bfloat16), (1024, torch.float32), (4, torch.float32)],
                         ids=["bf16-d16", "f32-d1024", "f32-d4"])
def test_delta_takes_any_row_count(cuda, rows, d, dtype):
    """Row counts that leave most of the last block idle: 2 lanes a row at
    bf16 D = 16 (128 rows a block), a warp a row at f32 D = 1024, a lane a
    row at f32 D = 4; the vector form within the f32 tolerance of the plain
    version, the general one too."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(rows) + d)
    out, dout = _qkvo(gen, rows + (d,), dtype, cuda)[:2]
    want = attention.row_dot_plain(out, dout)
    tol = chip_smoke.k3_tolerances(torch)[torch.float32]
    before = attention.delta_form_counts()
    got = attention.row_dot(out, dout)
    assert chip_smoke.delta_forms_since(attention, before) == {attention.delta_form(d, dtype, True): 1}
    for x in (got, attention._launch_delta(out, dout, ("general", 32))):
        assert x.shape == (rows[0], rows[2], rows[1])
        assert float((x - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_delta_copies_a_non_contiguous_input(cuda, dtype):
    """A transposed view is copied by ``_dense`` and takes the vector form:
    bitwise the result of its contiguous copy."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(71)
    out, dout = _qkvo(gen, (2, 33, 3, 64), dtype, cuda)[:2]
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (out, dout)]
    assert not any(x.is_contiguous() for x in views)
    before = attention.delta_form_counts()
    got = attention.row_dot(*views)
    assert chip_smoke.delta_forms_since(attention, before) == {
        attention.delta_form(64, dtype, True): 1}
    assert torch.equal(got, attention.row_dot(out, dout))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_delta_on_a_view_off_16_byte_alignment(cuda, dtype):
    """Rows one element off a 16-byte boundary are the general form's:
    ``delta_form`` names it, the kernel's entry refuses a vector launch on
    them, and the general form on them as they lie holds the f32 tolerance.
    ``row_dot`` copies such a view first, as every K3 wrapper does, and gives
    bitwise its contiguous copy's result."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(73)
    dense = _qkvo(gen, (2, 33, 3, 64), dtype, cuda)[:2]

    def offset(x):
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
        return y.copy_(x)

    out, dout = (offset(x) for x in dense)
    assert out.is_contiguous() and out.data_ptr() % 16 and dout.data_ptr() % 16
    assert attention.delta_form(64, dtype, False) == ("general", 32)
    lanes = attention.delta_form(64, dtype, True)[1]
    with pytest.raises(RuntimeError, match="attn_bwd_delta"):
        attention._launch_delta(out, dout, ("vector", lanes))
    want = attention.row_dot_plain(out, dout)
    got = attention._launch_delta(out, dout, ("general", 32))
    tol = chip_smoke.k3_tolerances(torch)[torch.float32]
    assert float((got - want).abs().max()) <= tol * max(1.0, float(want.abs().max()))
    assert torch.equal(attention.row_dot(out, dout), attention.row_dot(*dense))


def test_delta_vector_form_refuses_what_it_does_not_take(cuda):
    """The C entry refuses (cudaErrorInvalidValue) a vector launch with lanes
    other than the rule's, or on rows off 16 bytes; the wrappers never ask."""
    x = torch.zeros((1, 8, 2, 1024), dtype=torch.bfloat16, device=cuda)
    for lanes in (16, 64, 3):
        with pytest.raises(RuntimeError, match="attn_bwd_delta"):
            attention._launch_delta(x, x, ("vector", lanes))
    y = torch.zeros((1, 8, 2, 12), dtype=torch.bfloat16, device=cuda)  # 24-byte rows
    with pytest.raises(RuntimeError, match="attn_bwd_delta"):
        attention._launch_delta(y, y, ("vector", 1))
    assert torch.equal(attention._launch_delta(x, x, ("vector", 32)),
                       torch.zeros((1, 2, 8), device=cuda))


def test_delta_past_2_31_elements_takes_the_general_form(cuda):
    """At B*T*H*D = 2^31 (4 GiB a bf16 tensor) the vector form's 32-bit
    indices would not do: ``row_dot`` takes the general form, the entry
    refuses a vector launch, and every row's sum, 1024 x 0.5 x 2, is exact."""
    shape = (1, 1 << 20, 2, 1024)
    out = torch.full(shape, 0.5, dtype=torch.bfloat16, device=cuda)
    dout = torch.full(shape, 2.0, dtype=torch.bfloat16, device=cuda)
    before = attention.delta_form_counts()
    got = attention.row_dot(out, dout)
    assert chip_smoke.delta_forms_since(attention, before) == {("general", 32): 1}
    assert bool((got == 1024.0).all())
    with pytest.raises(RuntimeError, match="attn_bwd_delta"):
        attention._launch_delta(out, dout, ("vector", 32))
    del out, dout, got
    torch.cuda.empty_cache()


def test_one_fabricnet_step_on_the_card_matches_the_cpu(cuda):
    cfg = fabricnet.FabricNetConfig(d_model=32, d_ff=64, d_expert=32, layers_per_stage=2,
                                    batch=4, seq=32, microbatches=2, heads=2)
    rng = np.random.default_rng(9)
    mesh = make_fabric_mesh(1, device="cpu")
    arrays = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.2
              for k, v in fabricnet.init_params(cfg, mesh).items()}
    x, y = (rng.standard_normal((4, 32, 32)).astype(np.float32) for _ in range(2))
    results = {}
    for dev in ("cpu", "cuda"):
        params = fabricnet.params_from_numpy(arrays, cfg, dev)
        step = fabricnet.make_train_step(cfg, device=dev)
        before = kernels.launch_counts()
        params, loss = step(params, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        after = kernels.launch_counts()
        results[dev] = (float(loss), {k: p.cpu() for k, p in params.items()})
        if dev == "cuda":  # f32: the 3xTF32 fold, dK/dV and dQ
            assert all(after[n] == before[n] + cfg.microbatches
                       for n in ("attn_fold_fwd_tf32", "attn_bwd_dkdv_tf32", "attn_bwd_dq_tf32")
                       + K3_BOTH)
            assert all(after[n] == before[n]
                       for n in ("attn_fold_fwd_tc", "attn_bwd_dkdv_tc", "attn_bwd_dq_tc"))
            assert {n: after[n] - before[n] for n in chip_smoke.K4 + chip_smoke.K4F} == \
                chip_smoke.k4_launches_per_step(cfg)
            assert {n: after[n] - before[n] for n in chip_smoke.K4E} == \
                chip_smoke.k4e_launches_per_step(cfg)
    assert results["cuda"][0] == pytest.approx(results["cpu"][0], rel=1e-5)
    for name, want in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][name], want, rtol=1e-5, atol=1e-5)


def test_one_heads0_fabricnet_step_on_the_card_matches_the_cpu(cuda):
    """heads = 0 (the ring mean, K4f), f32: one train step on the card
    against the CPU from the same weights, within 1e-5 (cuBLAS and the CPU
    sum in other orders); launches counted as chip_smoke.py
    counts them: K4f once each way a microbatch, no K3 kernel."""
    cfg = fabricnet.FabricNetConfig(d_model=32, d_ff=64, d_expert=32, layers_per_stage=2,
                                    batch=4, seq=32, microbatches=2, heads=0)
    rng = np.random.default_rng(13)
    mesh = make_fabric_mesh(1, device="cpu")
    arrays = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.2
              for k, v in fabricnet.init_params(cfg, mesh).items()}
    x, y = (rng.standard_normal((4, 32, 32)).astype(np.float32) for _ in range(2))
    results = {}
    for dev in ("cpu", "cuda"):
        params = fabricnet.params_from_numpy(arrays, cfg, dev)
        step = fabricnet.make_train_step(cfg, device=dev)
        before = kernels.launch_counts()
        params, loss = step(params, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
        after = kernels.launch_counts()
        results[dev] = (float(loss), {k: p.cpu() for k, p in params.items()})
        if dev == "cuda":
            assert all(after[n] == before[n] for n in chip_smoke.K3)
            assert {n: after[n] - before[n] for n in chip_smoke.K4 + chip_smoke.K4F} == \
                chip_smoke.k4_launches_per_step(cfg)
            assert after["ring_mean_add_fwd"] - before["ring_mean_add_fwd"] == cfg.microbatches
    assert results["cuda"][0] == pytest.approx(results["cpu"][0], rel=1e-5)
    for name, want in results["cpu"][1].items():
        torch.testing.assert_close(results["cuda"][1][name], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,offset", chip_smoke.K4F_CASES,
                         ids=["4x1024x2048", "ragged-t", "odd-d", "offset", "past-shared"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4f_matches_plain_versions(cuda, shape, offset, dtype):
    """K4f's forward (with delta and without) and its gradient bit for bit
    their plain versions, as chip_smoke.py holds them: at the bench width,
    a ragged T, an odd d, one element off 16-byte alignment, and a T whose
    column tile does not fit in shared memory."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape) + offset)
    errs = {name: {} for name in chip_smoke.K4F}
    before = kernels.launch_counts()
    chip_smoke.k4f_case(torch, elementwise, gen, cuda, shape, dtype, offset, errs)
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in chip_smoke.K4F} == {
        "ring_mean_add_fwd": 2, "ring_mean_add_bwd": 1}
    assert all(e == 0.0 for name in chip_smoke.K4F for e in errs[name].values())


@pytest.mark.parametrize("shape,offset,sp", chip_smoke.K4F_SP_CASES + [((3, 36, 40), True, 2)],
                         ids=["2x1024x2048-sp2", "2x1024x2048-sp4", "3x36x40-sp3", "odd-d-sp2",
                              "offset-sp4", "past-shared-sp3", "offset-sp2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4f_sp_form_matches_plain_versions(cuda, shape, offset, sp, dtype):
    """K4f's sp form (each rank's block mean folded around the sp ring in
    the rank's own order) bit for bit its plain versions, forward with
    delta and without and the gradient, one launch each."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape) + offset + sp)
    errs = {name: {} for name in chip_smoke.K4F}
    before = kernels.launch_counts()
    chip_smoke.k4f_case(torch, elementwise, gen, cuda, shape, dtype, offset, errs, sp)
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in chip_smoke.K4F} == {
        "ring_mean_add_fwd": 2, "ring_mean_add_bwd": 1}
    assert all(e == 0.0 for name in chip_smoke.K4F for e in errs[name].values())


@pytest.mark.parametrize("heads", [2, 0], ids=["heads2", "heads0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mesh_step_with_kernels_matches_plain_versions(cuda, heads, dtype):
    """One fused train step on {pp2 sp2 ep2}, all 8 ranks on the card, at
    ``chip_smoke.MESH_SMALL``: with the kernels against the same step with
    every plain version from the same parameters
    (``chip_smoke.mesh_step_check``): the loss, every leaf's gradient and
    the update bit for bit, float32 within ``MESH_SMALL_F32_TOL`` and
    bfloat16 within phase 7d's tolerances, each planted 1% fault in a
    backward kernel refused; the launches as phase 7d counts them."""
    cfg = fabricnet.FabricNetConfig(heads=heads, dtype=dtype, **chip_smoke.MESH_SMALL)
    mesh = make_fabric_mesh(8, axis_sizes={"pp": 2, "sp": 2, "ep": 2}, device=cuda)
    start = fabricnet.init_params(cfg, mesh, seed=21)
    x, y = fabricnet.make_batch(cfg, mesh, seed=22)
    step = fabricnet.make_train_step(cfg, mesh)
    before = kernels.launch_counts()
    step({k: v.clone() for k, v in start.items()}, x, y)
    after = kernels.launch_counts()
    with chip_smoke.plain_versions():
        step({k: v.clone() for k, v in start.items()}, x, y)
    assert kernels.launch_counts() == after  # the plain versions launch nothing
    got = {n: after[n] - before[n] for n in chip_smoke.K4 + chip_smoke.K4F + chip_smoke.K4E}
    assert got == {**chip_smoke.k4_launches_per_step(cfg, 2),
                   **chip_smoke.k4e_launches_per_step(cfg, "fused", mesh.shape)}
    if dtype == torch.bfloat16:
        assert {n: after[n] - before[n] for n in chip_smoke.K3} == \
            chip_smoke.k3_launches_per_step(cfg, mesh.shape)
    r = chip_smoke.mesh_step_check(torch, fabricnet, cfg, mesh, start, x, y)
    chip_smoke.hold_mesh_step(r, "mesh step", *chip_smoke.mesh_step_tols(torch, dtype))


def test_k4f_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 8, 16), device=cuda)
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        elementwise.ring_mean_add_fwd(x.double())
    with pytest.raises(ValueError, match="batch, T, d"):
        elementwise.ring_mean_add_bwd(x[0])
    with pytest.raises(ValueError, match="delta"):
        elementwise.ring_mean_add_fwd(x, x.bfloat16())
    with pytest.raises(ValueError, match="sp=3"):
        elementwise.ring_mean_add_fwd(x, None, 3)
    assert kernels.launch_counts() == before


# K4 at the bench_fabricnet shapes and at odd widths, contiguous and one
# element off 16-byte alignment, as chip_smoke.py holds it
@pytest.mark.parametrize("shape,offset", [(shape, False) for shape in chip_smoke.K4_SHAPES]
                         + chip_smoke.K4_ODD,
                         ids=["4096x2048", "4096x8192", "2x2048x2048", "5x33", "3x1000",
                              "4x33-offset", "4x1000-offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4_matches_plain_versions(cuda, shape, offset, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(shape) + offset)
    errs = {name: {} for name in chip_smoke.K4}
    before = kernels.launch_counts()
    chip_smoke.k4_case(torch, elementwise, gen, cuda, shape, dtype, offset, errs, {})
    after = kernels.launch_counts()
    # K4a with and without delta, K4b with and without g_s, K4c, K4d
    assert {n: after[n] - before[n] for n in chip_smoke.K4} == {
        "add_rms_norm_fwd": 2, "rms_norm_bwd": 2, "gelu_tanh_fwd": 1, "gelu_tanh_bwd": 1}


@pytest.mark.parametrize("dtype,d,offset", chip_smoke.K4A_CAP,
                         ids=[f"{t}-{d}-{'off' if o else 'aligned'}"
                              for t, d, o in chip_smoke.K4A_CAP])
def test_k4a_on_both_sides_of_its_register_cap(cuda, dtype, d, offset):
    """K4a at the widest rows it keeps in registers and the next widths,
    which it reads twice, with and without delta, aligned and one element
    off 16-byte alignment, against its plain version as chip_smoke.py
    holds it; two launches."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(d + offset)
    before = kernels.launch_counts()
    once = chip_smoke.k4a_cap_case(torch, elementwise, gen, cuda, dtype, d, offset, {})
    assert once == (chip_smoke.K4A_CAP.index((dtype, d, offset)) % 2 == 0)
    assert kernels.launch_counts()["add_rms_norm_fwd"] == before["add_rms_norm_fwd"] + 2


def test_k4_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.float64, device=cuda)
    before = kernels.launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        elementwise.add_rms_norm_fwd(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        elementwise.gelu_tanh_fwd(x)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4e_update_matches_its_plain_version_bitwise(cuda, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(17)
    chip_smoke.k4e_update_cases(torch, update, fabricnet, gen, cuda, dtype)


# K4e-b/c/d at chip_smoke.py's shapes, and the odd ones one element off alignment
@pytest.mark.parametrize("moe_shape,loss_shape,offset",
                         [(m, l, False) for m, l in zip(chip_smoke.K4E_MOE_SHAPES,
                                                        chip_smoke.K4E_LOSS_SHAPES)]
                         + [(m, l, True) for m, l in zip(chip_smoke.K4E_MOE_SHAPES[2:],
                                                         chip_smoke.K4E_LOSS_SHAPES[2:])],
                         ids=["bench", "slice", "odd33", "odd1000", "odd33-offset",
                              "odd1000-offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_k4e_matches_plain_versions(cuda, moe_shape, loss_shape, offset, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sum(moe_shape) + offset)
    errs = {name: {} for name in chip_smoke.K4E}
    before = kernels.launch_counts()
    chip_smoke.k4e_case(torch, elementwise, gen, cuda, dtype, moe_shape, loss_shape, offset,
                        errs, {})
    after = kernels.launch_counts()
    assert {n: after[n] - before[n] for n in chip_smoke.K4E} == {
        "sgd_update_multi": 0, "moe_combine_fwd": 1, "moe_combine_bwd": 1, "mse_loss_fwd": 2}


def test_k4e_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    p = torch.zeros((4, 8), dtype=torch.float64, device=cuda)
    before = kernels.launch_counts()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        update.sgd_update_multi("fused", [p], [p], 0.01)
    q = torch.zeros((8, 4), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        update.sgd_update_multi("fused", [q.t()], [q.t()], 0.01)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        elementwise.mse_loss_fwd(p, p)
    with pytest.raises(ValueError, match="no elements"):
        elementwise.mse_loss_fwd(q[:0], q[:0])
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("slices", [2, 3])
def test_sliced_schedules_on_the_card_match_the_cpu(cuda, slices):
    """Serialized and overlapped byte for byte on the card; within the fused
    step's 1e-5 of the CPU's sliced step (f32; cuBLAS and the CPU sum in
    other orders); every kernel counted as chip_smoke.py counts it."""
    cfg = fabricnet.FabricNetConfig(d_model=32, d_ff=64, d_expert=32, layers_per_stage=2,
                                    batch=6, seq=32, microbatches=slices, heads=2)
    rng = np.random.default_rng(11)
    mesh = make_fabric_mesh(1, device="cpu")
    arrays = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.2
              for k, v in fabricnet.init_params(cfg, mesh).items()}
    x, y = (torch.from_numpy(rng.standard_normal((6, 32, 32)).astype(np.float32))
            for _ in range(2))
    results = {}
    for dev, schedule in (("cpu", "serialized"), ("cuda", "serialized"), ("cuda", "overlapped")):
        params = fabricnet.params_from_numpy(arrays, cfg, dev)
        step = fabricnet.make_train_step(cfg, device=dev, schedule=schedule)
        before = kernels.launch_counts()
        losses = [step(params, x.to(dev), y.to(dev))[1] for _ in range(2)]
        after = kernels.launch_counts()
        results[(dev, schedule)] = (torch.stack(losses).cpu(),
                                    {k: p.cpu() for k, p in params.items()})
        if dev == "cuda":
            want = {**{n: 2 * slices for n in ("attn_fold_fwd_tf32", "attn_bwd_dkdv_tf32",
                                                "attn_bwd_dq_tf32") + K3_BOTH},
                    **{n: 2 * v for n, v in chip_smoke.k4_launches_per_step(cfg).items()},
                    **{n: 2 * v for n, v in chip_smoke.k4e_launches_per_step(cfg, schedule).items()}}
            assert {n: after[n] - before[n] for n in want} == want
    (ls, ps), (lo, po) = results[("cuda", "serialized")], results[("cuda", "overlapped")]
    assert ls.dtype == torch.float32 and torch.equal(ls, lo)
    assert all(torch.equal(ps[k].view(torch.int32), po[k].view(torch.int32)) for k in ps)
    lc, pc = results[("cpu", "serialized")]
    torch.testing.assert_close(ls, lc, rtol=1e-5, atol=0)
    for name, want in pc.items():
        torch.testing.assert_close(ps[name], want, rtol=1e-5, atol=1e-5)


K2 = ("quantize_rows", "dequant_mean_rows")


def _bits(t):
    return t.cpu().contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("parties,width,block", [(3, 4096, 32), (3, 4096, 16), (8, 1 << 20, 32)])
def test_k2_matches_plain_versions_and_the_numpy_twin(cuda, mode, parties, width, block):
    nfloats = width // 4
    rows = chip_smoke.quant_rows(parties, nfloats, block, mode, seed=parties + block)
    x = torch.from_numpy(rows).to(cuda)
    before = kernels.launch_counts()
    q, e = quantize.quantize_rows(x, mode, block)
    mean = quantize.dequant_mean_rows(q, e, mode, block)
    deq = quantize.dequant_mean_rows(q, e, mode, block, mean=False)
    after = kernels.launch_counts()
    assert after["quantize_rows"] == before["quantize_rows"] + 1
    assert after["dequant_mean_rows"] == before["dequant_mean_rows"] + 2
    qp, ep = quantize.quantize_rows_plain(x, mode, block)
    assert np.array_equal(_bits(q), _bits(qp)) and np.array_equal(_bits(e), _bits(ep))
    assert np.array_equal(_bits(mean), _bits(quantize.dequant_mean_rows_plain(qp, ep, mode, block)))
    assert np.array_equal(_bits(deq), _bits(quantize.dequantize_rows_plain(qp, ep, mode, block)))
    with np.errstate(over="ignore"):  # the FLT_MAX edge block dequantizes to +inf
        twins = [Q.np_quantize(r, mode, block) for r in rows]
        deqs = [Q.np_dequantize(tq, te, mode, block) for tq, te in twins]
        want_mean = np.sum(np.stack(deqs), axis=0, dtype=np.float32) / np.float32(parties)
    for r, (tq, te) in enumerate(twins):
        assert _bits(q[r]).tobytes() == tq.tobytes() and _bits(e[r]).tobytes() == te.tobytes()
        assert _bits(deq[r]).tobytes() == deqs[r].tobytes()
        assert _bits(mean[r]).tobytes() == want_mean.tobytes()
    # a chunk of the state, cut at a block boundary, is quantized in place
    cut = 2 * block
    qc, ec = quantize.quantize_rows(x[:, cut:2 * cut], mode, block)
    qw, ew = quantize.quantize_rows_plain(x[:, cut:2 * cut].contiguous(), mode, block)
    assert np.array_equal(_bits(qc), _bits(qw)) and np.array_equal(_bits(ec), _bits(ew))


# (parties, row bytes, block, layout): the blocks K2a's and K2b's vector forms
# take, 1 to 64 parties (1: a checkpoint's one row), and the general forms'
# blocks (6 and 10) and layouts (chip_smoke.k2_layout: rows off 16-byte
# boundaries, and q one byte off its word for K2b)
K2_FORM_CASES = ([(3, 4096, b, "contiguous") for b in (8, 16, 32, 64, 128)]
                 + [(p, 4096, 32, "contiguous") for p in (1, 8, 64)]
                 + [(3, 3840, 6, "contiguous"), (3, 3840, 10, "contiguous"),
                    (3, 4096, 32, "offset"), (3, 4096, 32, "stride")])


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("parties,width,block,layout", K2_FORM_CASES,
                         ids=[f"P{p}-W{w}-b{b}-{lay}" for p, w, b, lay in K2_FORM_CASES])
def test_k2_forms_match_plain_versions_and_the_numpy_twin(cuda, mode, parties, width, block, layout):
    """Each form of K2a and K2b bitwise the plain versions and the numpy
    twin (the mean and mean=False) on rows that all carry the edge blocks,
    with the form each launch took asserted (chip_smoke.k2_case)."""
    before = kernels.launch_counts()
    forms = chip_smoke.k2_case(torch, quantize, Q, cuda, parties, width, block, mode, layout)
    after = kernels.launch_counts()
    assert forms == chip_smoke.k2_expected_forms(block, mode, layout)
    # the case's rows and its noise rows: two quantizes; four dequantizes (the
    # mean, its one-row form, mean=False, and the noise rows' mean)
    assert after["quantize_rows"] - before["quantize_rows"] == 2
    assert after["dequant_mean_rows"] - before["dequant_mean_rows"] == 4


def test_k2_vector_forms_refuse_what_they_do_not_take(cuda):
    """The C entries refuse a vector launch off its alignments or blocks
    (cudaErrorInvalidValue) rather than run it; the wrappers never ask."""
    lib = kernels.build()
    stream = torch.cuda.current_stream().cuda_stream
    buf = torch.zeros((2, 68), dtype=torch.float32, device=cuda)
    q = torch.empty((2, 64), dtype=torch.int8, device=cuda)
    e = torch.empty((2, 2), dtype=torch.int8, device=cuda)
    out = torch.empty((2, 64), dtype=torch.float32, device=cuda)
    off = buf[:, 1:65]
    assert quantize.quantize_form(off, 32) == "general"
    assert lib.tb_quantize_rows(off.data_ptr(), 68, 2, 64, 32, 0, 1, q.data_ptr(), e.data_ptr(),
                                stream) != 0
    # block 16 fits; block 24 is 6 lanes' float4s, not a power of two
    assert lib.tb_quantize_rows(buf.data_ptr(), 68, 2, 48, 24, 0, 1, q.data_ptr(), e.data_ptr(),
                                stream) != 0
    assert lib.tb_quantize_rows(buf.data_ptr(), 68, 2, 64, 16, 0, 1, q.data_ptr(),
                                torch.empty((2, 4), dtype=torch.int8, device=cuda).data_ptr(),
                                stream) == 0
    # q one byte off its 32-bit word (one party, one output row)
    assert lib.tb_dequant_mean_rows(q.data_ptr() + 1, e.data_ptr(), 1, 32, 32, 0, 1, 1, 1,
                                    out.data_ptr(), stream) != 0
    # no output row, and a dequantize (mean=0) into fewer rows than parties
    assert lib.tb_dequant_mean_rows(q.data_ptr(), e.data_ptr(), 2, 32, 32, 0, 1, 1, 0,
                                    out.data_ptr(), stream) != 0
    assert lib.tb_dequant_mean_rows(q.data_ptr(), e.data_ptr(), 2, 32, 32, 0, 0, 1, 1,
                                    out.data_ptr(), stream) != 0
    torch.cuda.synchronize()


def test_k2_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        quantize.quantize_rows(x.t().contiguous().t(), "int8", 32)
    with pytest.raises(ValueError, match="odd"):
        quantize.quantize_rows(x, "int4", 1)
    q, e = quantize.quantize_rows(x, "int8", 32)
    with pytest.raises(ValueError):
        quantize.dequant_mean_rows(q, e.cpu(), "int8", 32)
    with pytest.raises(TypeError):
        quantize.dequant_mean_rows(q.view(torch.uint8), e, "int8", 32)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_session_on_the_card_matches_the_cpu(cuda, mode):
    width, steps = 4096, 4
    rows = chip_smoke.quant_rows(3, width // 4, 32, mode, seed=11, edges=False)
    dm = mc_collective._pmean_dm(width)
    got = {}
    for dev in ("cpu", "cuda"):
        before = kernels.launch_counts()
        row, n, _ = mc_dispatch.run_dispatch_session(
            [0, 1, 2], 0, dm, [r.tobytes() for r in rows], steps,
            service=mc_collective.PMEAN_SERVICE, method=mc_collective.PMEAN_METHOD,
            quantize=mode, chunks=2, double_buffer=True, device=dev,
        )
        after = kernels.launch_counts()
        got[dev] = bytes(row[:n])
        if dev == "cuda":
            assert all(after[k] == before[k] + steps * 2 for k in K2)
    assert got["cuda"] == got["cpu"]


def test_stream_over_tcp_and_the_forced_device_link_on_the_card(cuda):
    from incubator_brpc_tpu_torch import rpc
    from incubator_brpc_tpu_torch.transport import device_link as dl

    checks = []

    def open_stream(cntl, request):
        checks.append(chip_smoke.StreamCheck(int(request)))
        rpc.stream_accept(cntl, rpc.StreamOptions(handler=checks[-1]))
        return b"%d" % (len(checks) - 1)

    server = rpc.Server(rpc.ServerOptions())
    server.add_service("stream", {"open": open_stream})
    assert server.start(0)
    try:
        msgs = chip_smoke.stream_messages()
        for transport in ("tcp", "tpu"):
            ch = rpc.Channel()
            assert ch.init(f"127.0.0.1:{server.port}",
                           options=rpc.ChannelOptions(transport=transport, timeout_ms=120_000))
            with chip_smoke.forced_device_links(dl):
                msgs_per_s, mb_per_s, full = chip_smoke.stream_run(rpc, ch, checks, msgs)
            assert msgs_per_s > 0 and mb_per_s > 0 and full > 0
            if transport == "tpu":
                link = ch._device_sock.link
                assert link._step is not None and link.devices[0].type == "cuda"
    finally:
        server.stop()
        assert server.join(timeout=60)
        rpc.shutdown_host_plane()


def test_mc_pair_on_the_card_keeps_its_rows_there(cuda):
    from incubator_brpc_tpu_torch.transport import mc_worker as mc

    pair, _ = mc.orchestrate_pair(extra=("--n-rpcs", "4", "--device-rpcs", "8"),
                                  server_extra=("--device-echo",), device="cuda:0",
                                  backend="gloo", timeout=300)
    server = pair["servers"]["server"]
    chip_smoke.halves_agree(pair, server["links"][0], "pair on the card")
    assert pair["device_rpcs"] == 8
    assert server["k1_launches"]["frame_rows"] > 0
    assert server["k1_launches"]["echo_step_rows"] > 0


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_k2b_one_row_form_matches_its_plain_version(cuda, mode):
    """K2b with ``out_rows=1`` (a rank's one row in a session across
    processes) bitwise its plain version and the full form's row 0, at 3
    parties of 1 MiB, in both forms (q one byte off its word takes the
    general one); one launch each."""
    rows = chip_smoke.quant_rows(3, (1 << 20) // 4, 32, mode, seed=77, edges=False)
    q, e = quantize.quantize_rows(torch.from_numpy(rows).to(cuda), mode, 32)
    off = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    off.copy_(q)  # q one byte into a contiguous buffer
    plain = quantize.dequant_mean_rows_plain(q.cpu(), e.cpu(), mode, 32, out_rows=1)
    full = quantize.dequant_mean_rows(q, e, mode, 32)
    for qq, form in ((q, "vector"), (off, "general")):
        assert quantize.dequant_form(qq, mode, 32) == form
        before = kernels.launch_counts()["dequant_mean_rows"]
        one = quantize.dequant_mean_rows(qq, e, mode, 32, out_rows=1)
        assert kernels.launch_counts()["dequant_mean_rows"] == before + 1
        assert one.shape == (1, (1 << 20) // 4)
        assert np.array_equal(_bits(one), _bits(plain)), form
        assert np.array_equal(_bits(one[0]), _bits(full[0])), form


def test_two_process_session_on_the_card(cuda):
    """A session with one party per rank, both processes on cuda:0 over
    gloo: the user kernel byte for byte its model, the exact, int8 and
    int4 pmean sessions byte for byte their models, K2 launched in both
    processes (steps x the two quantized sessions), and the distributed
    party axis gathering int8 and uint8 rows from the card in their own
    dtype."""
    from incubator_brpc_tpu_torch.transport import mc_worker as mc

    stats, transcript = mc.orchestrate_session(n_parties=2, steps=4, quantize="int8,int4",
                                               device="cuda:0", backend="gloo", timeout=300)
    assert all(r["bitwise_model"] for r in stats["pmean"].values()), transcript
    for rec in (stats, stats["servers"]["server0"]):
        assert rec["k2_launches"] == {"quantize_rows": 8, "dequant_mean_rows": 8}, transcript
    records = mc.orchestrate_probe(device="cuda:0", backend="gloo", axis=True)
    for r in records:
        assert r["device"] == "cuda:0" and set(r["axis"]) >= {"gather_int8", "gather_uint8"}


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_k2a_vector_form_takes_one_row_and_its_chunk_views(cuda, mode):
    """What a rank quantizes in a session across processes: its own row
    ``[1, 1 MiB]`` and, in a chunked session, the views of it cut at the
    chunk width; each in K2a's vector form, bitwise its plain version."""
    rows = chip_smoke.quant_rows(1, (1 << 20) // 4, 32, mode, seed=91, edges=False)
    row = torch.from_numpy(rows).to(cuda)
    cw = row.shape[1] // 4
    for x in (row, *(row[:, j * cw:(j + 1) * cw] for j in range(4))):
        assert quantize.quantize_form(x, 32) == "vector"
        before = quantize.form_counts()[("quantize_rows", "vector")]
        q, e = quantize.quantize_rows(x, mode, 32)
        assert quantize.form_counts()[("quantize_rows", "vector")] == before + 1
        qp, ep = quantize.quantize_rows_plain(x.contiguous(), mode, 32)
        assert np.array_equal(_bits(q), _bits(qp)) and np.array_equal(_bits(e), _bits(ep))
