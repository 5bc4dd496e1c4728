"""incubator_brpc_tpu_torch — the RPC fabric's device data plane in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

This package stands beside ``incubator_brpc_tpu`` (the JAX package, which
stays the reference) and is held against it by parity tests. It imports
``torch`` and numpy, never ``jax`` and nothing of ``incubator_brpc_tpu``:
the JAX-free pieces it needs (status codes, flags, bvar, the runtime, the
host RPC plane) are its own copies.

Modules mirror the reference package's layout so each counterpart is easy to
find: ``ops/framing.py`` (frames in device memory), ``ops/kernels.py`` and
``csrc/framing.cu`` (the kernels), ``models/tensor_echo.py`` (the fused echo
step), ``runtime/device_butex.py`` (completion wake-ups on CUDA events),
``transport/device.py`` (``DeviceEndpoint``), and the training path:
``ops/attention.py`` with ``csrc/attention.cu`` (K3, the ring-attention
fold and its gradient), ``models/ring_attention.py``,
``parallel/mesh.py`` (the one-card fabric mesh) and ``models/fabricnet.py``;
and the collective sessions: ``ops/quantize.py`` with ``csrc/quantize.cu``
(K2, block quantize and dequantize-mean), ``parallel/quantized.py``,
``parallel/mc_dispatch.py`` (``run_dispatch_session``),
``parallel/mc_collective.py`` and ``rpc/device_method.py``; and the host
plane that carries calls to the card: ``rpc/`` (``Server``, ``Channel``,
``Controller``) over ``protocol/tbus_std.py``, ``transport/`` (sockets,
the acceptor, the event dispatchers), ``runtime/`` (the worker pool and
correlation ids) and ``iobuf.py``, in plain Python.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (:func:`resolve_device`).
"""

from __future__ import annotations

__version__ = "0.1.0"

_LAZY_SUBMODULES = (
    "utils",
    "bvar",
    "ops",
    "models",
    "transport",
    "runtime",
    "parallel",
    "protocol",
    "rpc",
)


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        mod = importlib.import_module(f"incubator_brpc_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'incubator_brpc_tpu_torch' has no attribute {name!r}")
