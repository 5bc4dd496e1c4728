"""Flag registry — analog of the reference's gflags + reloadable_flags.

The port's copy of the JAX package's registry, trimmed to the registry
itself and the flags this package reads (the host plane's among them).
Runtime mutation goes through ``set_flag`` (validator-bearing flags only,
like the reference's /flags service, src/brpc/reloadable_flags.h) or
``set_flag_unchecked``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class _Flag:
    name: str
    value: Any
    default: Any
    help: str
    type: type
    validator: Optional[Callable[[Any], bool]] = None
    reloadable: bool = False


class FlagRegistry:
    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}
        self._lock = threading.Lock()

    def define(
        self,
        name: str,
        default: Any,
        help: str = "",
        validator: Optional[Callable[[Any], bool]] = None,
    ) -> None:
        with self._lock:
            if name in self._flags:
                return  # idempotent (module reloads in tests)
            self._flags[name] = _Flag(
                name=name,
                value=default,
                default=default,
                help=help,
                type=type(default),
                validator=validator,
                reloadable=validator is not None,
            )

    def get(self, name: str) -> Any:
        return self._flags[name].value

    def set(self, name: str, value: Any) -> bool:
        """Set a reloadable (validator-bearing) flag; others are refused."""
        with self._lock:
            f = self._flags[name]
            if not f.reloadable:
                return False
            value = f.type(value)
            if not f.validator(value):
                return False
            f.value = value
            return True

    def set_unchecked(self, name: str, value: Any) -> None:
        with self._lock:
            f = self._flags[name]
            f.value = f.type(value)

    def items(self):
        return sorted(self._flags.items())


flag_registry = FlagRegistry()
define_flag = flag_registry.define
get_flag = flag_registry.get
set_flag = flag_registry.set
set_flag_unchecked = flag_registry.set_unchecked


# -- the host plane (runtime/, transport/, protocol/, rpc/) ---------------------
# Defaults and checks as in the JAX package's utils/flags.py.

define_flag("health_check_interval", 3, "seconds between health-check probes of a failed socket", lambda v: v > 0)
define_flag(
    "event_dispatcher_num",
    4,
    "number of event dispatchers (sockets hash across them by fd); client "
    "reads run inline on them, so this is sized like a small worker pool",
)
define_flag("fiber_concurrency", 8, "number of worker threads in the fiber scheduler")
define_flag(
    "fiber_concurrency_max",
    256,
    "elastic ceiling of the fiber scheduler: blocking fibers occupy a worker "
    "1:1, so the pool grows while none is idle (reference elastic growth from "
    "bthread_min_concurrency, task_control.cpp:382-390)",
)
define_flag("max_body_size", 64 * 1024 * 1024, "maximum message body size", lambda v: v > 0)
define_flag(
    "max_decompress_bytes",
    256 * 1024 * 1024,
    "decompressed-size ceiling for compressed request/response payloads "
    "(protocol/compress.py): a tiny bomb must not expand unbounded into "
    "server memory; 0 disables the ceiling (read per decompress)",
    lambda v: v >= 0,
)
define_flag(
    "native_compress_min_bytes",
    0,
    "response-compression floor: a request that arrived compressed gets its "
    "response recompressed with the same codec only when the payload has at "
    "least this many bytes (the reference's response_compress_type "
    "discipline); 0 = always recompress. The name is the JAX package's, "
    "whose native plane reads the same flag",
    lambda v: v >= 0,
)
define_flag(
    "native_telemetry",
    True,
    "per-port completion-record ring on native-plane servers: every "
    "natively dispatched request records method/latency/sizes/error into "
    "a lock-free MPSC ring drained into per-method latency summaries, "
    "sampled rpcz spans, and limiter feedback (read at Server.start)",
    lambda v: True,
)
define_flag(
    "native_telemetry_ring_size",
    8192,
    "telemetry ring capacity in records (rounded up to a power of two); "
    "a full ring drops records and counts them instead of blocking",
    lambda v: v > 0,
)
define_flag(
    "native_telemetry_sample_every",
    64,
    "every Nth native completion record is span-sampled into /rpcz "
    "(counter-based, exact-rate; 0 disables span sampling)",
    lambda v: v >= 0,
)
define_flag(
    "native_telemetry_drain_ms",
    100,
    "background drain cadence of the native telemetry ring; scrapes and "
    "Server.stop force a drain regardless",
    lambda v: v > 0,
)
define_flag("enable_rpcz", False, "collect rpcz spans", lambda v: True)
define_flag("rpcz_keep_span_seconds", 1800, "span retention", lambda v: v > 0)
define_flag("rpcz_max_spans", 10000, "max spans retained in memory", lambda v: v > 0)
define_flag(
    "rpcz_samples_per_second",
    1000,
    "span sampling speed limit (reference bvar::Collector COLLECTOR_SAMPLING_BASE)",
    lambda v: v > 0,
)
define_flag(
    "rpcz_database_dir",
    "",
    "persist finished spans as JSON lines under this directory "
    "(reference span.cpp:41 LevelDB persistence); empty = memory only",
    lambda v: isinstance(v, str),
)
define_flag(
    "rpcz_database_max_bytes",
    64 * 1024 * 1024,
    "rotate the span database file past this size",
    lambda v: v > 0,
)
define_flag(
    "enable_dir_service",
    False,
    "serve the /dir filesystem-browse builtin page (an unauthenticated "
    "file read on the portal: keep off unless the port is trusted)",
    lambda v: True,
)
define_flag(
    "socket_max_unwritten_bytes",
    64 * 1024 * 1024,
    "write-queue backpressure threshold (EOVERCROWDED)",
    lambda v: v > 0,
)
define_flag(
    "enable_quitquitquit",
    False,
    "serve the /quitquitquit graceful-quit trigger (an unauthenticated "
    "remote DRAIN-AND-STOP on the portal: keep off unless the port is "
    "trusted — the reference gates its quit endpoints the same way)",
    lambda v: True,
)
define_flag(
    "http_gateway_async_timeout_s",
    30,
    "how long the http->rpc gateway waits for an async handler",
    lambda v: v > 0,
)
define_flag(
    "async_response_timeout_s",
    30.0,
    "fail a binary-path async handler (cntl.set_async) that has not sent "
    "its response after this long, releasing its admission slot; 0 "
    "disables the reap",
    lambda v: v >= 0,
)

define_flag(
    "device_cq_threads",
    8,
    "completion-watcher threads; bounds overlapped device->host readbacks (rdma_cq_num analog)",
)

# -- the collective session plane (parallel/mc_dispatch.py) --------------------

define_flag(
    "mc_dispatch_min_steps",
    0,
    "minimum step count this party accepts into a collective-method "
    "session: its accept ack raises the session target to at least this "
    "(the proposer folds every target with max — the N-party join)",
    lambda v: v >= 0,
)

define_flag(
    "mc_dispatch_session_deadline_ms",
    0,
    "default per-session deadline for collective-method sessions: a "
    "session older than this aborts fabric-wide with ESESSION (every "
    "party watches its own copy, so a partitioned party still unwedges); "
    "0 = inherit the proposal's RPC timeout",
    lambda v: v >= 0,
)

define_flag(
    "mc_dispatch_checkpoint_every",
    0,
    "checkpoint cadence (in lockstep steps) for collective-method "
    "sessions: every C completed steps each party retains its "
    "device-resident operand shards in a ring, so an aborted session can "
    "resume from the last COMMON checkpoint instead of step 0; the "
    "proposer stamps the cadence into the run proposal so every party "
    "checkpoints the same steps; 0 = checkpointing off (abort = restart)",
    lambda v: v >= 0,
)

define_flag(
    "mc_dispatch_checkpoint_depth",
    4,
    "ring depth of the per-party checkpoint store: how many checkpointed "
    "steps stay device-resident per session (older entries are evicted "
    "oldest-first; memory cost per entry is parties x width bytes)",
    lambda v: v >= 1,
)

define_flag(
    "mc_dispatch_step_deadline_ms",
    0,
    "per-STEP watchdog for collective-method sessions: a single lockstep "
    "step (dispatch-to-dispatch progress, or the final fetch) stalled "
    "longer than this aborts the session fabric-wide — bounding a wedge "
    "INSIDE one step instead of waiting out the whole session deadline; "
    "0 = off (the session deadline is the only backstop)",
    lambda v: v >= 0,
)

# --- device-link re-handshake backoff (transport/device_link.py) -----------
define_flag(
    "device_link_backoff_initial_ms",
    100,
    "first re-handshake backoff after a device link dies",
    lambda v: v > 0,
)
define_flag(
    "device_link_backoff_max_ms",
    30000,
    "ceiling of the exponentially doubling re-handshake backoff",
    lambda v: v > 0,
)

# --- naming (naming/__init__.py) ---------------------------------------------
define_flag(
    "ns_refresh_interval_s",
    1.0,
    "polling period of periodic naming services (reference -ns_access_interval)",
    lambda v: v > 0,
)

# --- adaptive server-side concurrency limiter (reference
# src/brpc/policy/auto_concurrency_limiter.cpp DEFINE_* family; same
# names minus the auto_cl_ prefix collisions) -------------------------------
define_flag(
    "auto_cl_sample_window_size_ms",
    1000,
    "max duration of one limiter sampling window",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_min_sample_count",
    100,
    "a window with fewer samples than this is discarded on timeout",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_max_sample_count",
    200,
    "a window updates the limit as soon as it holds this many samples",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_sampling_interval_us",
    100,
    "at most one latency sample is fed to the limiter per interval",
    lambda v: v >= 0,
)
define_flag(
    "auto_cl_initial_max_concurrency",
    40,
    "max_concurrency='auto' starts from this limit",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_noload_latency_remeasure_interval_ms",
    5000,
    "period of the probe-down that re-measures no-load latency (the "
    "reference remeasures every ~50s; shorter here because test traffic "
    "lives in seconds)",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_alpha_factor_for_ema",
    0.1,
    "EMA keep-rate applied when min_latency shrinks",
    lambda v: 0 < v <= 1,
)
define_flag(
    "auto_cl_qps_alpha_factor_for_ema",
    0.1,
    "EMA keep-rate applied when the qps ceiling decays",
    lambda v: 0 < v <= 1,
)
define_flag(
    "auto_cl_max_explore_ratio",
    0.3,
    "upper bound of the gradient explore ratio",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_min_explore_ratio",
    0.06,
    "lower bound of the gradient explore ratio",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_change_rate_of_explore_ratio",
    0.02,
    "step the explore ratio moves per window",
    lambda v: v > 0,
)
define_flag(
    "auto_cl_reduce_ratio_while_remeasure",
    0.9,
    "probe-down multiplier applied to max_concurrency while remeasuring",
    lambda v: 0 < v < 1,
)
define_flag(
    "auto_cl_fail_punish_ratio",
    1.0,
    "how much of a failed call's latency charges the average",
    lambda v: v >= 0,
)

# --- per-node circuit breaker (reference src/brpc/circuit_breaker.cpp) -----
define_flag(
    "enable_circuit_breaker",
    True,
    "LB channels isolate nodes whose error rate trips the breaker",
    lambda v: True,
)
define_flag(
    "circuit_breaker_short_window_size",
    1500,
    "sample size of the breaker's short (fast-trip) window",
    lambda v: v > 0,
)
define_flag(
    "circuit_breaker_long_window_size",
    3000,
    "sample size of the breaker's long (slow-burn) window",
    lambda v: v > 0,
)
define_flag(
    "circuit_breaker_short_window_error_percent",
    10,
    "max error percent the short window tolerates",
    lambda v: 0 < v <= 100,
)
define_flag(
    "circuit_breaker_long_window_error_percent",
    5,
    "max error percent the long window tolerates",
    lambda v: 0 < v <= 100,
)
define_flag(
    "circuit_breaker_min_isolation_duration_ms",
    100,
    "first isolation lasts this long",
    lambda v: v > 0,
)
define_flag(
    "circuit_breaker_max_isolation_duration_ms",
    30000,
    "ceiling of the exponentially doubling isolation duration",
    lambda v: v > 0,
)
define_flag(
    "circuit_breaker_epsilon_value",
    0.02,
    "EMA epsilon: a sample's weight decays to this across one window",
    lambda v: 0 < v < 1,
)

# --- deterministic fault injection (proof plane; default off) --------------
define_flag(
    "fault_injection",
    False,
    "master gate for the FaultInjector seams (socket write + server "
    "dispatch); flip on to let the flag-built global injector act",
    lambda v: True,
)
define_flag(
    "fault_inject_error_rate",
    0.0,
    "fraction of server dispatches failed with EINTERNAL by the global "
    "injector (deterministic counter-based schedule, not random)",
    lambda v: 0 <= v <= 1,
)
define_flag(
    "fault_inject_delay_ms",
    0.0,
    "delay added by the global injector when the delay schedule fires",
    lambda v: v >= 0,
)
define_flag(
    "fault_inject_delay_rate",
    0.0,
    "fraction of operations delayed by the global injector",
    lambda v: 0 <= v <= 1,
)
define_flag(
    "fault_inject_close_rate",
    0.0,
    "fraction of socket writes that instead kill the connection",
    lambda v: 0 <= v <= 1,
)
