"""The port's entry points (``incubator_brpc_tpu_torch/graft_entry.py``,
ROADMAP A5) on the CPU, held against the JAX package's
``__graft_entry__.py``.

- ``entry()`` of both packages from the same numpy parameters: the JAX
  entry's parameters and batch carried across with ``params_from_numpy``
  (``models/fabricnet.py``); its request bytes equal the JAX entry's, the
  FabricNet forward within ``atol=1e-5`` (the float32 tolerance of
  ``tests/test_torch_fabricnet.py``; outputs are O(1-10)) of the JAX
  ``fn`` under ``jax.jit`` (as the JAX entry is driven), and the echo
  response bit for bit.
- ``dryrun_multichip(8)`` on ``device="cpu"`` with three parties where the
  JAX dry run has eight (the session and the int8 session; the overlapped
  session, the chaos drill and the fabric's two servers are the JAX
  counts), run through chip_smoke.py's phase 13 (``entry_phase``, which
  rehearses the phase on the CPU): its printed line carries every key of
  the JAX line in the JAX order, the fused flag as run (False: the links
  share one device, ROADMAP A3c) and the cut party counts. The JAX
  ``test_graft_entry_dryrun`` is left as it is.

Tolerance: ``atol=1e-5`` for the forward; none elsewhere.
"""

import ast
import re

import jax
import numpy as np
import torch

import __graft_entry__ as jax_entry
from incubator_brpc_tpu_torch import graft_entry
from incubator_brpc_tpu_torch.models import fabricnet
from tests.test_torch_observability import nothing_outlives_the_test  # noqa: F401  (fixture)

# the keys of the JAX dry run's line (__graft_entry__.py:264-270) and of its
# multi_controller_link record (:338-350)
LINE_KEYS = ("meshes=", "losses=", "device_link=", "wire_ack_link=ok", "nparty_fabric_peers=",
             "fused_collective=", "multi_controller_link=")
MC_KEYS = {"rpcs", "steps", "peer_ack", "devices", "fabric_3proc", "collective_3proc",
           "mc_lowered_parallel", "collective_8proc", "overlapped_session", "quantized_8proc",
           "chaos_resume"}


def test_entry_matches_the_jax_entry_on_the_same_parameters():
    jfn, (jparams, jx, jrequest) = jax_entry.entry()
    jfwd, jresp = jax.jit(jfn)(jparams, jx, jrequest)

    fn, (params, x, request) = graft_entry.entry(device="cpu")
    assert sorted(params) == sorted(jparams)
    cfg = fabricnet.FabricNetConfig(batch=4, seq=8, microbatches=2)
    params = fabricnet.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, cfg,
                                         "cpu")
    x = torch.from_numpy(np.asarray(jx, np.float32).copy())
    # the port frames the same request bytes
    assert request.view(torch.int32).numpy().tobytes() == np.asarray(jrequest).tobytes()
    fwd, resp = fn(params, x, request)
    assert fwd.shape == tuple(jfwd.shape) == (4, 8, 32)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), rtol=0, atol=1e-5)
    assert resp.view(torch.int32).numpy().tobytes() == np.asarray(jresp).tobytes()


def test_dryrun_multichip_prints_every_key_of_the_jax_line(capsys):
    """Through chip_smoke.py's phase 13 on the CPU (``entry_phase``: the
    tensor_echo_tpu example, ``entry()``'s fn against itself, then the dry
    run), its printed line read back whole."""
    import chip_smoke
    from incubator_brpc_tpu_torch.ops import kernels

    out, launched = chip_smoke.entry_phase(
        torch, kernels, device="cpu", parties=dict(session_parties=3, quantized_parties=3))
    assert launched == {"a": {}, "b": {}, "c": {}}  # no card, no launch
    assert out["b"]["max_abs_err"] == 0.0 and out["b"]["forward_shape"] == [4, 8, 32]
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("dryrun_multichip ok: ")]
    assert line.startswith("dryrun_multichip ok: 8 ranks on cpu, ")
    positions = [line.index(key) for key in LINE_KEYS]
    assert positions == sorted(positions)  # in the JAX line's order
    assert "fused_collective=False (the links share one device: the host fan-out; ROADMAP A3c)" \
        in line
    note = ", parties={'session': 3, 'quantized': 3} (the JAX dry run's: " \
           "{'session': 8, 'quantized': 8})"
    assert line.endswith(note)
    fields = line[len("dryrun_multichip ok: 8 ranks on cpu, "):-len(note)]
    meshes = ast.literal_eval(re.search(r"meshes=(\[.*?\]), losses=", fields).group(1))
    assert meshes == [{"dp": 2, "pp": 2, "tp": 2, "sp": 1, "ep": 1},
                      {"dp": 1, "pp": 2, "tp": 1, "sp": 2, "ep": 2}]
    losses = ast.literal_eval(re.search(r"losses=(\[[^]]*\])", fields).group(1))
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "device_link=['cpu', 'cpu']" in fields
    assert "nparty_fabric_peers=['cpu', 'cpu', 'cpu', 'cpu']" in fields
    mc = ast.literal_eval(fields.split("multi_controller_link=", 1)[1])
    assert set(mc) == MC_KEYS
    assert len({rank for rank, _dev in mc["devices"]}) == 2  # two distinct ranks
    assert mc["collective_8proc"]["parties"] == 3 and mc["overlapped_session"]["chunks"] == 4
    q = mc["quantized_8proc"]
    assert q["parties"] == 3 and q["wire_ratio"] <= 0.3 and q["max_error"] <= q["error_bound"]
    assert mc["chaos_resume"]["byte_identical"] and mc["chaos_resume"]["replaced_party_ids"]
