"""The collective-method plane's integer test kernels — the counterpart of
the top of ``incubator_brpc_tpu/transport/mc_worker.py`` (:39-80).

Module-level so every party minting a DeviceMethod from them resolves the
SAME fingerprint (module.qualname + source + geometry). Integer arithmetic
end to end, so results are bit-exact across planes and devices:
``session_expected`` is their host model, the bitwise oracle of the
session tests. The multi-process worker harness of the JAX module comes
with the port's multi-controller slice.
"""

from __future__ import annotations

import numpy as np
import torch

SESSION_WIDTH = 512


def _scale_psum_kernel(data, n, axis):
    """psum + elementwise — a user kernel that actually exercises the
    party axis (``axis.psum``, the JAX kernel's ``lax.psum(x, "par")``)."""
    x = data.to(torch.int32)
    s = axis.psum(x)
    return ((3 * s + x) % 256).to(torch.uint8), n


def _scale_psum_kernel_wrong(data, n, axis):
    """Same name, different body — the divergence the fingerprint check
    must reject before any party enters lockstep."""
    x = data.to(torch.int32)
    s = axis.psum(x)
    return ((5 * s + x) % 256).to(torch.uint8), n


def session_expected(operands, steps: int, width: int = SESSION_WIDTH):
    """Host-side model of the K-step _scale_psum_kernel chain: exact
    integer arithmetic, so every party's device result must match these
    bytes bit-for-bit."""
    rows, ns = [], []
    for op in operands:
        row = np.zeros(width, np.int64)
        row[: len(op)] = np.frombuffer(op, np.uint8)
        rows.append(row)
        ns.append(len(op))
    x = np.stack(rows)
    for _ in range(steps):
        s = x.sum(axis=0)
        x = (3 * s[None, :] + x) % 256
    return [bytes(x[i, : ns[i]].astype(np.uint8)) for i in range(len(rows))]
