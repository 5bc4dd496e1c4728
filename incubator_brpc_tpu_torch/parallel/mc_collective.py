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
(K2) attached. ``make_collective_handler`` and ``propose_collective``, the
RPC half, come with the port's host plane.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.bvar import Adder, LatencyRecorder
from incubator_brpc_tpu_torch.parallel import mc_dispatch
from incubator_brpc_tpu_torch.parallel import quantized as _quantized
from incubator_brpc_tpu_torch.rpc.device_method import DeviceMethod
from incubator_brpc_tpu_torch.utils.device import DeviceLike

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
) -> Tuple[np.ndarray, float]:
    """Run a pmean session of ``width`` float32 values per party; returns
    (party ``own_index``'s final row, elapsed seconds). One step pulls
    every party to the global mean, the invariant each party checks."""
    dm = _pmean_dm(4 * width)
    # every party's operand derives from the seed
    operands = [
        _party_operand(seed, i, width).tobytes()
        for i in range(len(party_ids))
    ]
    try:
        own_row, own_n, elapsed = mc_dispatch.run_dispatch_session(
            party_ids, own_index, dm, operands, steps,
            service=PMEAN_SERVICE, method=PMEAN_METHOD, device=device,
        )
    except Exception:
        collective_errors << 1
        raise
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
