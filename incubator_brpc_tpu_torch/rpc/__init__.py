"""rpc — the user-facing host API (reference L5: src/brpc/channel.h,
server.h, controller.h) over tbus_std, and the device methods
(``device_method.py``) that the collective session plane
(``parallel/mc_dispatch.py``) resolves by (service, method).

A ``DeviceEndpoint.server_handler()`` (transport/device.py) or a
``device_method()`` handler mounts on a ``Server`` like any handler, so a
``Channel`` call reaches the card — over TCP, or over the two-party device
link with ``ChannelOptions(transport="tpu")`` (transport/device_link.py).
A Channel also takes a naming url and a load balancer (``lb/``,
``naming/``), and the combo channels (``combo.py``: ParallelChannel,
SelectiveChannel, PartitionChannel, DynamicPartitionChannel) fan one call
out over several Channels.
"""

from incubator_brpc_tpu_torch.rpc.channel import (
    Channel,
    ChannelOptions,
    client_socket_map,
    start_cancel,
)
from incubator_brpc_tpu_torch.rpc.circuit_breaker import CircuitBreaker, breaker_registry
from incubator_brpc_tpu_torch.rpc.combo import (
    CallMapper,
    DynamicPartitionChannel,
    ParallelChannel,
    PartitionChannel,
    PartitionParser,
    ResponseMerger,
    SelectiveChannel,
    SubCall,
)
from incubator_brpc_tpu_torch.rpc.controller import Controller
from incubator_brpc_tpu_torch.rpc.device_method import device_method
from incubator_brpc_tpu_torch.rpc.server import MethodStatus, Server, ServerOptions


def shutdown_host_plane() -> None:
    """Close every client connection and every client device link (and
    wait for their last steps), then stop and join the host plane's
    process-wide threads: the event dispatchers (``tbtorch-dispatcher-*``)
    and the worker pool (``tbtorch-worker-*``). Stop and join every Server
    first. The next Channel or Server starts them again; the timer thread
    has its own ``shutdown_global_timer_thread``."""
    from incubator_brpc_tpu_torch.runtime.worker_pool import shutdown_global_worker_pool
    from incubator_brpc_tpu_torch.transport.device_link import shutdown_links
    from incubator_brpc_tpu_torch.transport.event_dispatcher import (
        shutdown_global_dispatchers,
    )

    client_socket_map().recycle_all()
    shutdown_links()
    shutdown_global_dispatchers()
    shutdown_global_worker_pool()


__all__ = [
    "CallMapper",
    "Channel",
    "ChannelOptions",
    "CircuitBreaker",
    "Controller",
    "DynamicPartitionChannel",
    "ParallelChannel",
    "PartitionChannel",
    "PartitionParser",
    "ResponseMerger",
    "SelectiveChannel",
    "SubCall",
    "breaker_registry",
    "MethodStatus",
    "Server",
    "ServerOptions",
    "shutdown_host_plane",
    "device_method",
    "start_cancel",
]
