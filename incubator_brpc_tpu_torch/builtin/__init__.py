"""builtin — the server's HTTP portal and the observability surface
(reference L6: src/brpc/builtin/*, span.{h,cpp}).

- rpcz:   sampled per-RPC spans (builtin/rpcz_service.cpp analog)
- portal: process-wide registry of running servers, introspected by the
  builtin pages (pages.py: /vars /status /flags /rpcz /connections
  /hotspots and the rest of the JAX package's table)
- prometheus: the /brpc_metrics exposition and its scrape hooks
- hotspots: the CPU, contention and heap profiles
"""

from incubator_brpc_tpu_torch.builtin import portal, rpcz
from incubator_brpc_tpu_torch.builtin.rpcz import Span, span_store

__all__ = ["portal", "rpcz", "Span", "span_store"]
