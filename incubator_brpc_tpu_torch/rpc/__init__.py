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
out over several Channels. A call may open a streaming RPC
(``stream.py``: ``stream_create`` on the client, ``stream_accept`` in the
handler), over TCP or over a device link. ``ServerOptions(native_plane=True)``
and ``ChannelOptions(native_plane=True)`` put a server or a channel on the
C++ host runtime (transport/native_plane.py); ``native_echo``,
``native_nop`` and ``native_long_running`` mark handlers it runs natively.
The server and channel policies: admission limits
(``concurrency_limiter.py``, ELIMIT), credentials (``auth.py``), the fault
injector (``fault_injector.py``), request dumps (``dump.py``), pooled
session and thread-local data (``data_pool.py``, ``thread_local_data``),
the lame duck and the idle reaper on the Server, and the retry budget,
the retry policy and backup requests on the Channel.
"""

from incubator_brpc_tpu_torch.rpc.channel import (
    Channel,
    ChannelOptions,
    client_socket_map,
    start_cancel,
)
from incubator_brpc_tpu_torch.rpc.auth import (
    Authenticator,
    SharedSecretAuthenticator,
    TokenAuthenticator,
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
from incubator_brpc_tpu_torch.rpc.concurrency_limiter import (
    AutoConcurrencyLimiter,
    ConcurrencyLimiter,
    ConstantConcurrencyLimiter,
)
from incubator_brpc_tpu_torch.rpc.controller import Controller
from incubator_brpc_tpu_torch.rpc.device_method import device_method
from incubator_brpc_tpu_torch.rpc.fault_injector import FaultInjector, install_socket_injector
from incubator_brpc_tpu_torch.rpc.server import (
    MethodStatus,
    Server,
    ServerOptions,
    thread_local_data,
)
from incubator_brpc_tpu_torch.rpc.stream import (
    Stream,
    StreamHandler,
    StreamOptions,
    stream_accept,
    stream_create,
)
from incubator_brpc_tpu_torch.transport.native_plane import (
    native_echo,
    native_long_running,
    native_nop,
)


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
    "Authenticator",
    "AutoConcurrencyLimiter",
    "CallMapper",
    "Channel",
    "ChannelOptions",
    "CircuitBreaker",
    "ConcurrencyLimiter",
    "ConstantConcurrencyLimiter",
    "Controller",
    "DynamicPartitionChannel",
    "FaultInjector",
    "ParallelChannel",
    "PartitionChannel",
    "PartitionParser",
    "ResponseMerger",
    "SelectiveChannel",
    "SharedSecretAuthenticator",
    "SubCall",
    "TokenAuthenticator",
    "breaker_registry",
    "install_socket_injector",
    "MethodStatus",
    "Server",
    "ServerOptions",
    "shutdown_host_plane",
    "device_method",
    "native_echo",
    "native_long_running",
    "native_nop",
    "start_cancel",
    "Stream",
    "StreamHandler",
    "StreamOptions",
    "stream_accept",
    "stream_create",
    "thread_local_data",
]
