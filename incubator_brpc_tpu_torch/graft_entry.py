"""Entry points of the port, the counterpart of the JAX package's
``__graft_entry__.py``.

- ``entry()``: the one-card step — the tensor-echo RPC server step (parse,
  verify, dispatch, respond: the framing kernels K1) beside the FabricNet
  forward on the one-rank mesh. ``fn`` is a plain callable: PyTorch runs
  eagerly, and nothing is compiled around it.
- ``dryrun_multichip(n_ranks)``: the JAX dry run's gates in their one-card
  form, every rank on one device (``parallel/mesh.py``): one FabricNet
  train step on each of two 8-rank meshes, the device link echo (the host
  swap and wire acks), the 4-party PartitionChannel over links that share
  the device, the ParallelChannel with and without ``fuse_device_calls``
  (on one device the host fan-out answers both; the fused dispatch over
  distinct devices is ROADMAP A3c), and the multi-process gates over gloo,
  one party a rank.

Both run on the card unless ``device="cpu"``; without a card and without
that, they raise.
"""

from __future__ import annotations

from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device

# the JAX dry run's party counts (__graft_entry__.py _dryrun_multiprocess_link)
SESSION_PARTIES = 8
OVERLAP_PARTIES = 3
QUANTIZED_PARTIES = 8
CHAOS_PARTIES = 3
FABRIC_SERVERS = 2


def entry(device: DeviceLike = None):
    """Return ``(fn, args)``: ``fn(params, x, request)`` -> (the FabricNet
    forward of ``x`` on the one-rank mesh, the echo step's framed
    response to ``request``), with ``FabricNetConfig(batch=4, seq=8,
    microbatches=2)`` and a 256-word echo request."""
    from incubator_brpc_tpu_torch.models import fabricnet
    from incubator_brpc_tpu_torch.models.tensor_echo import TensorEchoService, make_echo_step
    from incubator_brpc_tpu_torch.parallel.mesh import make_fabric_mesh

    # the flagship forward on a one-rank mesh (every fabric axis 1: the
    # same code path as the 8-rank meshes)
    mesh = make_fabric_mesh(1, device=device)
    cfg = fabricnet.FabricNetConfig(batch=4, seq=8, microbatches=2)
    fabricnet.validate_config(cfg, mesh)
    params = fabricnet.init_params(cfg, mesh)
    x, _ = fabricnet.make_batch(cfg, mesh)

    echo = TensorEchoService()
    _, request = make_echo_step(payload_words=256, service=echo, device=mesh.device)
    fwd = fabricnet.make_forward_step(cfg, mesh)

    def fn(params, x, request):
        return fwd(params, x), echo.step(request)

    return fn, (params, x, request)


def _mesh_configs(n_ranks: int):
    """Two configs so EVERY fabric axis is >= 2 in at least one run:
    A = dp2 pp2 tp2, B = pp2 sp2 ep2 (at 8 ranks); other counts take the
    default factoring."""
    from incubator_brpc_tpu_torch.parallel.mesh import default_axis_sizes

    if n_ranks >= 8 and n_ranks % 8 == 0:
        half = n_ranks // 8
        return [
            {"dp": 2 * half, "pp": 2, "tp": 2, "sp": 1, "ep": 1},
            {"dp": half, "pp": 2, "tp": 1, "sp": 2, "ep": 2},
        ]
    return [default_axis_sizes(n_ranks)]


def _train_steps(configs, n_ranks: int, device) -> list:
    """One FabricNet train step on each mesh at the dry run's widths; the
    losses, each finite."""
    import math

    from incubator_brpc_tpu_torch.models import fabricnet
    from incubator_brpc_tpu_torch.parallel.mesh import make_fabric_mesh

    losses = []
    for sizes in configs:
        mesh = make_fabric_mesh(n_ranks, axis_sizes=sizes, device=device)
        dp, ep, sp = sizes["dp"], sizes["ep"], sizes["sp"]
        microbatches = 2
        cfg = fabricnet.FabricNetConfig(
            d_model=16,
            d_ff=32,
            d_expert=16,
            experts_per_rank=2,
            layers_per_stage=1,
            batch=dp * ep * microbatches * 2,
            seq=sp * max(4, 2 * ep * sizes["tp"]),
            microbatches=microbatches,
        )
        fabricnet.validate_config(cfg, mesh)
        params = fabricnet.init_params(cfg, mesh)
        x, y = fabricnet.make_batch(cfg, mesh)
        params, loss = fabricnet.make_train_step(cfg, mesh)(params, x, y)
        loss = float(loss)
        assert math.isfinite(loss), f"train-step loss is {loss} under mesh {sizes}"
        losses.append(loss)
    return losses


def _link_echo(device) -> list:
    """One ``transport="tpu"`` echo (the host swap: both halves on the one
    device), then one under ``link_ack_mode="wire"`` spanning several
    windowed steps. Returns the first link's devices."""
    from incubator_brpc_tpu_torch.rpc import (
        Channel, ChannelOptions, Controller, Server, ServerOptions,
    )

    server = Server(ServerOptions(device=device))
    server.add_service("EchoService", {"Echo": lambda cntl, req: req})
    assert server.start(0)
    try:
        ch = Channel()
        assert ch.init(
            f"127.0.0.1:{server.port}",
            options=ChannelOptions(transport="tpu", timeout_ms=60000),
        )
        cntl = ch.call_method("EchoService", "Echo", b"multichip device link")
        assert cntl.ok(), f"device-link echo failed: {cntl.error_text}"
        assert cntl.response_payload == b"multichip device link"
        link_devs = [str(d) for d in ch._device_sock.link.devices]

        chw = Channel()
        assert chw.init(
            f"127.0.0.1:{server.port}",
            options=ChannelOptions(
                transport="tpu", timeout_ms=60000,
                link_ack_mode="wire", link_slot_words=256, link_window=2,
            ),
        )
        big = bytes(range(256)) * 16  # spans several windowed steps
        cw = chw.call_method("EchoService", "Echo", big, cntl=Controller(timeout_ms=60000))
        assert cw.ok(), f"wire-ack echo failed: {cw.error_text}"
        assert cw.response_payload == big
        assert chw._device_sock.link.ack_mode == "wire"
    finally:
        server.stop()
        server.join(timeout=10)
    return link_devs


def _partition_fabric(device) -> list:
    """The 4-party PartitionChannel over four device links that share the
    client's device: every partition answers its part in order. Returns
    each link's server-side device."""
    from incubator_brpc_tpu_torch.rpc import (
        ChannelOptions, Controller, PartitionChannel, Server, ServerOptions,
    )

    servers = []
    for i in range(4):
        s = Server(ServerOptions(usercode_inline=True, device=device))
        s.add_service("part", {"get": (lambda cntl, req, _i=i: f"p{_i}:".encode() + req)})
        assert s.start(0)
        servers.append(s)
    try:
        url = "list://" + ",".join(f"127.0.0.1:{s.port} {i}/4" for i, s in enumerate(servers))
        pc = PartitionChannel()
        assert pc.init(
            url, partition_count=4,
            options=ChannelOptions(transport="tpu", timeout_ms=60000),
        )
        cntl = pc.call_method("part", "get", b"X", cntl=Controller(timeout_ms=60000))
        assert cntl.ok(), f"partitioned device RPC failed: {cntl.error_text}"
        assert cntl.response_payload == b"p0:Xp1:Xp2:Xp3:X"
        links = [sub[0]._device_sock.link for sub in pc._subs]
        assert len(links) == 4 and len({id(lk) for lk in links}) == 4
        assert len({str(lk.devices[0]) for lk in links}) == 1
        peers = sorted(str(lk.devices[1]) for lk in links)
        pc.stop()
    finally:
        for s in servers:
            s.stop()
            s.join(timeout=10)
    return peers


def _inc_kernel(data, n, axis):
    return data + 1, n  # uint8 rows: wraps at 256 as the JAX kernel does


def _parallel_fanout(device) -> bool:
    """A ParallelChannel over four device-method servers, with
    ``fuse_device_calls`` True and False: byte-identical merges. Returns
    whether the fused path was taken (False where the links share a
    device: the host fan-out answers)."""
    from incubator_brpc_tpu_torch.rpc import (
        Channel, ChannelOptions, Controller, ParallelChannel, Server, ServerOptions,
        device_method,
    )

    servers = []
    for _ in range(4):
        s = Server(ServerOptions(usercode_inline=True, device=device))
        s.add_service("dry", {"inc": device_method(_inc_kernel, width=256)})
        assert s.start(0)
        servers.append(s)
    try:
        pcs = {}
        for fuse in (True, False):
            pc = ParallelChannel(fuse_device_calls=fuse)
            for s in servers:
                ch = Channel()
                assert ch.init(
                    f"127.0.0.1:{s.port}",
                    options=ChannelOptions(transport="tpu", timeout_ms=60000),
                )
                pc.add_channel(ch)
            pcs[fuse] = pc
        f = pcs[True].call_method("dry", "inc", b"\x10\x20\x30", cntl=Controller(timeout_ms=60000))
        h = pcs[False].call_method("dry", "inc", b"\x10\x20\x30", cntl=Controller(timeout_ms=60000))
        assert f.ok() and h.ok(), (f.error_text, h.error_text)
        assert f.response_payload == h.response_payload == b"\x11\x21\x31" * 4
        assert not getattr(h, "collective_fused", False)
        return bool(getattr(f, "collective_fused", False))
    finally:
        for s in servers:
            s.stop()
            s.join(timeout=10)


def _dryrun_multiprocess_link(device, session_parties: int, quantized_parties: int) -> dict:
    """The multi-process gates over gloo, one party a rank, every rank on
    ``device``: the pair, the fabric with ``--mc-lowering-check``, the
    session, the overlapped one, the int8 session and the chaos drill.
    Raises if a gate fails — the gates are load-bearing, not advisory."""
    from incubator_brpc_tpu_torch.transport.mc_worker import (
        orchestrate_chaos_session,
        orchestrate_fabric,
        orchestrate_pair,
        orchestrate_session,
    )

    dev = str(device)
    stats, _ = orchestrate_pair(extra=("--n-rpcs", "4"), device=dev)
    # a party is its rank: the pair's two halves are two distinct ranks
    assert stats["peer_ack"] > 0 and len({p[0] for p in stats["parties"]}) == 2, stats
    fstats, _ = orchestrate_fabric(
        n_servers=FABRIC_SERVERS,
        extra=("--n-rpcs", "2", "--collective-steps", "16", "--mc-lowering-check"),
        device=dev,
    )
    assert len(fstats["links"]) == FABRIC_SERVERS
    assert all(lk["peer_ack"] > 0 for lk in fstats["links"])
    assert fstats["collective"] is not None  # the pipelined pmean over every rank
    assert fstats["mc_lowered"] is not None  # the combo call lowered to a session
    sstats, _ = orchestrate_session(n_parties=session_parties, steps=8, timeout=420, device=dev)
    assert sstats["parties"] == session_parties and sstats["steps"] >= 8
    ostats, _ = orchestrate_session(
        n_parties=OVERLAP_PARTIES, steps=8, timeout=420, chunks=4, double_buffer=True, device=dev
    )
    assert ostats["parties"] == OVERLAP_PARTIES and ostats["steps"] >= 8
    assert ostats["chunks"] == 4 and ostats["double_buffer"]
    qstats, _ = orchestrate_session(
        n_parties=quantized_parties, steps=8, timeout=420, quantize="int8", device=dev
    )
    q = qstats["pmean"]["int8"]
    assert qstats["parties"] == quantized_parties and q["bitwise_model"], qstats
    assert q["wire_ratio"] <= 0.3, qstats
    assert q["max_error"] <= q["error_bound"], qstats
    cstats, _ = orchestrate_chaos_session(
        n_parties=CHAOS_PARTIES, steps=8, kill_at=4, checkpoint_every=2, timeout=420, device=dev
    )
    assert cstats["byte_identical"] and cstats["replaced_party_ids"], cstats
    return {
        "rpcs": stats["n_rpcs"],
        "steps": stats["steps"],
        "peer_ack": stats["peer_ack"],
        "devices": stats["parties"],
        "fabric_3proc": [lk["parties"] for lk in fstats["links"]],
        "collective_3proc": fstats["collective"],
        "mc_lowered_parallel": fstats["mc_lowered"],
        "collective_8proc": sstats,
        "overlapped_session": ostats,
        "quantized_8proc": {**qstats, "quantize": "int8", "wire_ratio": q["wire_ratio"],
                            "max_error": q["max_error"], "error_bound": q["error_bound"]},
        "chaos_resume": cstats,
    }


def dryrun_multichip(
    n_ranks: int,
    device: DeviceLike = None,
    session_parties: int = SESSION_PARTIES,
    quantized_parties: int = QUANTIZED_PARTIES,
) -> dict:
    """Run the dry run's gates, every rank of ``n_ranks`` on ``device``
    (the card unless ``"cpu"``), and print one ``dryrun_multichip ok:``
    line with the JAX dry run's keys. The session's and the int8
    session's party counts default to the JAX dry run's 8; a caller
    passing fewer is named in the line. Returns the line's fields."""
    dev = resolve_device(device)
    configs = _mesh_configs(n_ranks)
    losses = _train_steps(configs, n_ranks, dev)
    link_devs = _link_echo(dev)
    nparty = _partition_fabric(dev)
    fused = _parallel_fanout(dev)
    mc_stats = _dryrun_multiprocess_link(dev, session_parties, quantized_parties)
    counts = {"session": session_parties, "quantized": quantized_parties}
    defaults = {"session": SESSION_PARTIES, "quantized": QUANTIZED_PARTIES}
    cut = {k: v for k, v in counts.items() if v != defaults[k]}
    fused_note = "" if fused else " (the links share one device: the host fan-out; ROADMAP A3c)"
    parties_note = (f", parties={cut} (the JAX dry run's: "
                    f"{ {k: defaults[k] for k in cut} })" if cut else "")
    print(
        f"dryrun_multichip ok: {n_ranks} ranks on {dev}, meshes={configs}, "
        f"losses={[round(l, 5) for l in losses]}, device_link={link_devs}, "
        f"wire_ack_link=ok, nparty_fabric_peers={nparty}, "
        f"fused_collective={fused}{fused_note}, "
        f"multi_controller_link={mc_stats}{parties_note}"
    )
    return {"ranks": n_ranks, "device": str(dev), "meshes": configs, "losses": losses,
            "device_link": link_devs, "wire_ack_link": "ok", "nparty_fabric_peers": nparty,
            "fused_collective": fused, "multi_controller_link": mc_stats,
            "parties": {**counts, "overlap": OVERLAP_PARTIES, "chaos": CHAOS_PARTIES,
                        "fabric_servers": FABRIC_SERVERS}}
