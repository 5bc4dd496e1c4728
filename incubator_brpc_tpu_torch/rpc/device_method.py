"""Device methods — RPC methods with a device kernel and a fixed row
geometry, the counterpart of ``incubator_brpc_tpu/rpc/device_method.py``.

A device method declares its kernel; the port's kernels take the whole
single-controller state, every party's row on dim 0, and the party axis
(``parallel/mesh.py`` :class:`PartyAxis`):

    kernel(data: uint8[P, width], n: int32[P], axis: PartyAxis)
        -> (uint8[P, width], int32[P])

where the JAX package's kernel sees one party's row and names the axis
``"par"``. The kernel is called as it is (PyTorch runs eagerly, so there is
no ``jitted()``). ``device_method()`` wraps a kernel into a host RPC
handler: a point-to-point call is a session of one party on the serving
Server's device.

Registering a device method is an explicit contract: the kernel sees only
request bytes, so it must be pure.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

DEFAULT_WIDTH = 4096


class DeviceMethod:
    """A bytes-in/bytes-out kernel with fixed row geometry.

    ``chunkable=True`` declares the kernel CHUNK-SAFE: applying it to any
    contiguous slice of the row produces the same bytes as slicing the
    full-width result (elementwise along the width, collectives included
    — psum of a slice is the slice of the psum), and it passes ``n``
    through unchanged.  Only chunk-safe kernels may run chunked overlap
    sessions (``parallel/mc_dispatch.py``); a session asking for
    ``chunks > 1`` against a method registered without the declaration is
    rejected before any step runs.  The declaration is a capability, not
    part of the kernel's identity — it does not enter the fingerprint."""

    def __init__(
        self,
        kernel: Callable,
        width: int = DEFAULT_WIDTH,
        chunkable: bool = False,
    ):
        self.kernel = kernel
        self.width = width
        self.chunkable = bool(chunkable)
        # chunk boundaries must fall on multiples of this many bytes for
        # the chunk-safety contract to hold (1 = any divisor of width).
        # Block-wise quantized kernels set it to the scale-block byte
        # span: a chunk cut mid-block would recompute block scales from a
        # partial block and diverge from the full-width bytes.
        self.chunk_align = 1
        # quantization surface (parallel/quantized.py): "none" for exact
        # kernels; a quantized VARIANT carries its mode + block size, and
        # collective_bytes declares how many bytes this kernel actually
        # puts on the wire per party per step (None = the full row width
        # — the exact-kernel default). Variants are separate DeviceMethods
        # (own kernel, own fingerprint) reachable via quantized().
        self.quant_mode = "none"
        self.quant_block = 0
        self.quant_variants: Dict[str, "DeviceMethod"] = {}
        self.collective_bytes: Optional[int] = None
        self._fingerprint: Optional[str] = None

    def quantized(self, mode: Optional[str]) -> Optional["DeviceMethod"]:
        """Resolve the session-uniform ``quantize=`` knob against this
        method: "none" (or empty) is the method itself; a quantized mode
        returns the registered variant — a DISTINCT DeviceMethod with its
        own fingerprint — or None when the method declares no such
        variant (the clean reject before any step)."""
        mode = (mode or "none").strip() or "none"
        if mode == "none" or mode == self.quant_mode:
            return self
        return self.quant_variants.get(mode)

    def wire_bytes(self) -> int:
        """Bytes this kernel ships across the party axis per party per
        step — the quantized wire footprint when declared, else the full
        row width (the exact float path)."""
        return (
            int(self.collective_bytes)
            if self.collective_bytes
            else int(self.width)
        )

    def fingerprint(self) -> str:
        """Stable identity of the kernel+geometry: the module, qualified
        name and source text of the kernel, its width, and its closure
        cells and defaults, so same-name/different-body kernels and two
        parametrizations minted by one factory differ."""
        if self._fingerprint is None:
            import hashlib
            import inspect

            ident = (
                f"{getattr(self.kernel, '__module__', '')}."
                f"{getattr(self.kernel, '__qualname__', repr(self.kernel))}"
                f":{self.width}"
            )
            try:
                ident += ":" + inspect.getsource(self.kernel)
            except (OSError, TypeError):
                pass
            clo = getattr(self.kernel, "__closure__", None) or ()
            for cell in clo:
                try:
                    ident += f"|cell:{cell.cell_contents!r}"
                except Exception:  # noqa: BLE001 — unrepr-able: be cautious
                    ident += "|cell:?"
            defaults = getattr(self.kernel, "__defaults__", None) or ()
            for d in defaults:
                try:
                    ident += f"|def:{d!r}"
                except Exception:  # noqa: BLE001
                    ident += "|def:?"
            self._fingerprint = hashlib.sha1(ident.encode()).hexdigest()[:16]
        return self._fingerprint

    def pack(self, request: bytes) -> Tuple[np.ndarray, np.int32]:
        if len(request) > self.width:
            raise ValueError(
                f"request of {len(request)}B exceeds device-method width "
                f"{self.width}"
            )
        row = np.zeros(self.width, dtype=np.uint8)
        row[: len(request)] = np.frombuffer(request, dtype=np.uint8)
        return row, np.int32(len(request))

    def unpack(self, row, n) -> bytes:
        n = int(n)
        return bytes(np.asarray(row[:n], dtype=np.uint8))

    def pack_state(self, row_bytes: bytes, n: int) -> Tuple[np.ndarray, np.int32]:
        """Re-materialize a checkpointed FULL-WIDTH state row — the
        elastic-session reshard format (parallel/mc_dispatch): unlike an
        operand (``pack``, ≤ width, zero-padded), a mid-chain state row
        must be exactly ``width`` bytes — the values beyond the original
        operand length are live kernel state, and silently padding a
        short row would resume a corrupted chain."""
        if len(row_bytes) != self.width:
            raise ValueError(
                f"state row of {len(row_bytes)}B != method width "
                f"{self.width}"
            )
        row = np.frombuffer(bytes(row_bytes), dtype=np.uint8).copy()
        return row, np.int32(int(n))


# (service, method) -> DeviceMethod (process-global, like the reference's
# method map being reachable from the protocol layer)
_registry: Dict[Tuple[str, str], DeviceMethod] = {}
_registry_lock = threading.Lock()


def register_device_method(service: str, method: str, dm: DeviceMethod) -> None:
    with _registry_lock:
        _registry[(service, method)] = dm


def lookup_device_method(service: str, method: str) -> Optional[DeviceMethod]:
    with _registry_lock:
        return _registry.get((service, method))


def unregister_device_method(service: str, method: str) -> Optional[DeviceMethod]:
    """Remove a registration (tests restoring a clean registry; a
    registered name SHADOWS the builtin width-minting resolvers, so a
    leaked fixture registration changes resolution for every later
    width).  Returns the removed DeviceMethod or None."""
    with _registry_lock:
        return _registry.pop((service, method), None)


def registry_fingerprints() -> Dict[str, str]:
    """Snapshot of every registered method's identity ("svc.m" ->
    fingerprint) — what a multi-controller handshake advertises so the
    peer can validate session proposals against a name it has seen."""
    with _registry_lock:
        items = list(_registry.items())
    return {f"{s}.{m}": dm.fingerprint() for (s, m), dm in items}


def device_method(
    kernel: Callable,
    width: int = DEFAULT_WIDTH,
    chunkable: bool = False,
) -> Callable:
    """Wrap a device kernel into a host RPC handler.

    The handler packs the request into one zero-padded row of ``width``
    bytes, puts it on the serving Server's device (``Server.device()``;
    the card when the handler is called outside a Server) as a
    ``[1, width]`` tensor with ``n`` as ``[1]``, calls the kernel with the
    party axis of one party, and answers row 0's first ``n`` bytes — the
    same kernel the session plane runs, so a point-to-point call and a
    session of one party return identical bytes. ``chunkable`` declares
    chunk-safety for overlap sessions (see :class:`DeviceMethod`).
    Registering the handler on a Server publishes ``_device_method``.
    """
    import torch

    from incubator_brpc_tpu_torch.parallel.mesh import PartyAxis
    from incubator_brpc_tpu_torch.utils.device import resolve_device

    dm = DeviceMethod(kernel, width=width, chunkable=chunkable)

    def handler(cntl, request: bytes) -> bytes:
        server = getattr(cntl, "_server", None)
        dev = server.device() if server is not None else resolve_device(None)
        row, n = dm.pack(request)
        data = torch.from_numpy(row).reshape(1, dm.width).to(dev)
        ns = torch.tensor([int(n)], dtype=torch.int32, device=dev)
        out_rows, out_n = dm.kernel(data, ns, PartyAxis(1, dev))
        out_n = int(out_n.reshape(-1)[0].item())
        return dm.unpack(out_rows[0, :out_n].cpu().numpy(), out_n)

    handler._device_method = dm
    return handler
