"""The port's collective sessions with one party per ``torch.distributed``
rank, on the CPU: the harness of ``transport/mc_worker.py`` with
``--device cpu --backend gloo``, each party its own process of one job,
under the assertions of tests/test_mc_dispatch.py's subprocess tier:

- the three-process session of the user kernel ``dsvc.scale`` (two server
  ranks and the proposing client, itself a party): every party's row byte
  for byte ``session_expected``, in the unchunked and the overlap
  schedules, and the in-process single-controller form's bytes;
- the fingerprint reject: one server registered a same-name kernel with a
  different body, and the accept phase refuses before any step runs;
- quantized sessions (int8 and int4) beside an exact one on the same
  float rows: the exact rows byte for byte the party-ordered f32 model
  (``mc_worker.pmean_model``), the quantized ones byte for byte
  ``np_quantized_pmean`` and within ``pmean_error_bound``, the wire ratio
  from the gathered dtypes;
- the ParallelChannel over two multi-controller links lowered to a
  one-step session over the servers' ranks, and a pmean session
  (``propose_collective``) over the fabric's three ranks;
- the distributed ``PartyAxis`` in two processes: ``all_gather`` of
  float32, int32, int8 and uint8 rows keeps their dtype, and
  ``all_gather`` and ``psum`` are byte for byte the single-controller
  form's on the stacked rows;
- the chaos drill: party 0's RPC server stops at step 3 of 8 while its
  process lives on; the session heals from the spare byte-identically (a
  full restart over the healed set, ``resumed_from`` None: across
  processes the dead slot's ring is out of reach);
- the JAX harness's three-process session beside the port's, where the
  JAX package can run multi-process computations on this CPU
  (``multiprocess_capable()``; this CPU build of jaxlib cannot, and then
  the port's session is held to the model alone).

tests/test_mc_dispatch.py's 8-party session and chaos drill are ``slow``
there and here (``chip_smoke.py`` phase 10b runs the drill on the card;
tests/test_torch_mc_link.py runs a shorter one among the harness options).
"""

import base64
import threading

import numpy as np
import pytest
import torch

import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu_torch.parallel import mc_collective as mcc
from incubator_brpc_tpu_torch.parallel import mc_dispatch as mcd
from incubator_brpc_tpu_torch.parallel import quantized as Q
from incubator_brpc_tpu_torch.parallel.mesh import party_axis
from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.transport import mc_worker

CPU = dict(device="cpu", backend="gloo")


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


@pytest.mark.parametrize("chunks,double_buffer", [(1, False), (4, True)])
def test_three_process_user_kernel_session(chunks, double_buffer):
    stats, transcript = mc_worker.orchestrate_session(n_parties=3, steps=4, chunks=chunks,
                                                      double_buffer=double_buffer, **CPU)
    assert stats["parties"] == 3 and stats["steps"] == 4, transcript
    assert stats["method"] == "dsvc.scale"
    assert len(stats["party_ms_per_step"]) == 3
    # every party crossed the session group once a step (a chunk)
    for rec in (stats, *stats["servers"].values()):
        assert rec["gathers"] == 4 * chunks, transcript
        assert rec["k2_launches"] == {"quantize_rows": 0, "dequant_mean_rows": 0}


def test_distributed_session_equals_the_single_controller_form():
    """The client checks every party's row against ``session_expected``;
    the single-controller form gives the same bytes in process."""
    stats, transcript = mc_worker.orchestrate_session(n_parties=3, steps=3, **CPU)
    assert stats["steps"] == 3, transcript
    ops = mc_worker.scale_operands(3)
    dm = DeviceMethod(mc_worker._scale_psum_kernel, width=mc_worker.SESSION_WIDTH)
    for own in range(3):
        row, n, _ = mcd.run_dispatch_session([0, 1, 2], own, dm, ops, 3, device="cpu")
        assert bytes(row[:n]) == mc_worker.session_expected(ops, 3)[own]


def test_fingerprint_mismatch_rejects_before_any_step():
    stats, transcript = mc_worker.orchestrate_session(n_parties=3, steps=4, wrong_kernel=True,
                                                      **CPU)
    assert stats.get("rejected") is True, transcript
    assert stats["sessions_run"] == 0
    for rec in stats["servers"].values():
        assert rec["gathers"] == 0, transcript


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_session_across_processes(quantize):
    stats, transcript = mc_worker.orchestrate_session(n_parties=3, steps=3, quantize=quantize,
                                                      **CPU)
    pm = stats["pmean"]
    assert pm["none"]["bitwise_model"], transcript
    q = pm[quantize]
    assert q["bitwise_model"] and q["max_error"] <= q["error_bound"]
    assert q["wire_ratio"] == Q.wire_bytes(mc_worker.SESSION_WIDTH, quantize) / mc_worker.SESSION_WIDTH


def test_both_quantized_modes_and_the_overlap_schedule_in_one_job():
    stats, transcript = mc_worker.orchestrate_session(n_parties=3, steps=2, quantize="int8,int4",
                                                      chunks=2, double_buffer=True, **CPU)
    assert set(stats["pmean"]) == {"none", "int8", "int4"}, transcript
    assert all(r["bitwise_model"] for r in stats["pmean"].values())


def test_parallel_channel_lowers_through_the_plane_and_a_fabric_collective():
    stats, transcript = mc_worker.orchestrate_fabric(
        n_servers=2, extra=("--n-rpcs", "2", "--mc-lowering-check", "--collective-steps", "3"),
        **CPU)
    assert stats["mc_lowered"] == {"bytes": 2 * 48, "parties": 2}, transcript
    assert stats["collective"]["parties"] == 3 and stats["collective"]["steps"] == 3


def test_distributed_party_axis_matches_the_single_controller_form():
    records = mc_worker.orchestrate_probe(axis=True, **CPU)
    assert [r["rank"] for r in records] == [0, 1]
    one = party_axis(2, "cpu")
    for dtype in mc_worker.AXIS_DTYPES:
        stacked = torch.from_numpy(np.concatenate(
            [mc_worker.axis_probe_rows(r, dtype) for r in (0, 1)]))
        want = one.all_gather(stacked).numpy().tobytes()
        for r in records:
            assert base64.b64decode(r["axis"][f"gather_{dtype}"]) == want, (dtype, r["rank"])
        if dtype in ("float32", "int32"):
            # the single-controller psum hands every party the same row
            want_row = one.psum(stacked)[0].numpy().tobytes()
            for r in records:
                assert base64.b64decode(r["axis"][f"psum_{dtype}"]) == want_row, dtype


@pytest.mark.slow
def test_chaos_party_dies_at_step_k_and_the_session_heals():
    stats, transcript = mc_worker.orchestrate_chaos_session(n_parties=3, steps=8, kill_at=3,
                                                            checkpoint_every=2, **CPU)
    assert stats["byte_identical"], transcript
    assert stats["dead_party_ids"] == [0] and stats["replaced_party_ids"] == [2]
    # the dead slot's ring is out of reach across processes: a full restart
    assert stats["resumed_from"] is None
    assert "SERVER_DYING" in transcript


def test_jax_harness_session_beside_the_port():
    """The JAX harness's session and the port's report the same parties,
    steps and method; where the JAX package cannot run multi-process
    computations on this CPU, the port's session stands alone, checked
    against the model by its client."""
    from incubator_brpc_tpu.transport import mc_worker as jax_worker

    port, transcript = mc_worker.orchestrate_session(n_parties=3, steps=4, **CPU)
    assert (port["parties"], port["steps"], port["method"]) == (3, 4, "dsvc.scale"), transcript
    if jax_worker.multiprocess_capable():
        ref, _ = jax_worker.orchestrate_session(n_parties=3, steps=4)
        assert (ref["parties"], ref["steps"], ref["method"]) == (3, 4, "dsvc.scale")


def test_pmean_model_is_the_in_process_exact_session():
    """``mc_worker.pmean_model`` (what the exact sessions across processes
    are held to) is the single-controller exact session's bytes."""
    rows = mc_worker.pmean_rows(3)
    dm = mcc._pmean_dm(mc_worker.SESSION_WIDTH)
    row, n, _ = mcd.run_dispatch_session([0, 1, 2], 1, dm, [r.tobytes() for r in rows], 3,
                                         device="cpu")
    assert bytes(row[:n]) == mc_worker.pmean_model(rows, 3).tobytes()


@pytest.mark.slow
def test_eight_party_session():
    stats, transcript = mc_worker.orchestrate_session(n_parties=8, steps=8, timeout=420, **CPU)
    assert stats["parties"] == 8 and stats["steps"] >= 8, transcript


def test_chip_smoke_phase_10b_on_the_cpu():
    """chip_smoke.py's phase 10b rehearsed at a small size: the in-process
    sessions over RPC bitwise their models, the session across three
    processes, the reject and the chaos drill (no card, no launch)."""
    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, in_process, across = chip_smoke.session_plane_phase(
        torch, kernels, device="cpu", parties=3, width=4096, steps=4,
        mc_session=dict(n_parties=3, steps=4, width=4096),
        chaos=dict(n_parties=3, steps=6, kill_at=2, checkpoint_every=2))
    assert [r["mode"] for r in out["in_process"]] == [m for m, _c, _d in chip_smoke.PLANE_RUNS]
    assert in_process == across == {"quantize_rows": 0, "dequant_mean_rows": 0}
    assert set(out["across"]["pmean"]) == {"none", "int8", "int4"}
    assert out["reject"]["rejected"] and out["chaos"]["byte_identical"]
    assert chip_smoke.plane_k2_per_session(8, 16, 4, "int8") == 512
    assert chip_smoke.plane_k2_per_session(8, 16, 1, "none") == 0


# -- ROADMAP C9: the session plane's per-run state stays bounded ---------------

_C9_PARTY = r"""
import json, sys
from incubator_brpc_tpu_torch.parallel import mc_dispatch as mcd
from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod
from incubator_brpc_tpu_torch.transport import mc_worker
from incubator_brpc_tpu_torch.utils import distributed as dist_mod

rank, port, sessions = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
job = dist_mod.init_job(rank, 2, port, "cpu", backend="gloo")
dm = DeviceMethod(mc_worker._scale_psum_kernel, width=mc_worker.SESSION_WIDTH)
ops = mc_worker.scale_operands(2)
want = mc_worker.session_expected(ops, 2)[rank]
trace = []
for i in range(sessions):
    row, n, _ = mcd.run_dispatch_session([0, 1], rank, dm, ops, 2, session_id=f"c9-{i}",
                                         device="cpu")
    assert bytes(row[:n]) == want
    trace.append([job.store.num_keys(), len(job._keys)])
# the job's epochs: a session id run again at an equal or lower epoch refuses
try:
    dist_mod.session_group(f"c9-{sessions - 1}", 0, [0, 1], "gloo", 5.0)
    refused = False
except ValueError:
    refused = True
job.store.add("c9-done", 1)
job.store.wait(["c9-done"])
while job.store.add("c9-done", 0) < 2:
    pass
print(json.dumps({"rank": rank, "trace": trace, "refused": refused,
                  "final_keys": job.store.num_keys()}))
"""


def test_job_keys_keep_the_highest_epoch_of_the_newest_prefixes():
    from incubator_brpc_tpu_torch.utils import distributed as dist_mod

    job = dist_mod.Job(0, 2, torch.device("cpu"), "gloo", torch.distributed.HashStore())
    job.claim_key("session/a", 3)
    for epoch in (0, 3):
        with pytest.raises(ValueError, match="already used"):
            job.claim_key("session/a", epoch)
    job.claim_key("session/a", 4)  # a resumed run is a new, higher epoch
    job.claim_key("link/x")
    with pytest.raises(ValueError):
        job.claim_key("link/x")
    for i in range(3 * dist_mod.KEYS_KEPT):
        job.claim_key(f"session/s{i}", 0)
    assert len(job._keys) == dist_mod.KEYS_KEPT
    with pytest.raises(ValueError):  # the newest prefixes are still guarded
        job.claim_key(f"session/s{3 * dist_mod.KEYS_KEPT - 1}", 0)


def test_eighty_sessions_leave_the_store_and_the_key_guard_bounded(tmp_path):
    """A CPU gloo job of two processes runs 80 sessions in a row: the
    TCPStore's key count stays at what one run leaves in flight, and
    ``Job._keys`` stops at ``KEYS_KEPT``."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from incubator_brpc_tpu_torch.utils.distributed import KEYS_KEPT

    sessions = 80
    assert sessions > KEYS_KEPT
    script = tmp_path / "c9_party.py"
    script.write_text(_C9_PARTY)
    port = mc_worker._free_ports(1)[0]
    root = str(Path(__file__).resolve().parent.parent)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(sessions)],
                              cwd=root, env={**os.environ, "PYTHONPATH": root},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    records = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for rec in records:
        assert rec["refused"]
        store_keys = [k for k, _ in rec["trace"]]
        guard = [g for _, g in rec["trace"]]
        # each run's rendezvous entries and arrival counter leave the store
        # (without the repair each run left two entries: 160 here)
        assert max(store_keys) <= 4, store_keys
        assert guard == [min(i + 1, KEYS_KEPT) for i in range(sessions)]
