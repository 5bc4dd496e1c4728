// tbnet — native L2/L3 network plane: epoll reactor, tbus_std AND
// baidu_std (PRPC) frame cut, method dispatch, and a client channel, all
// in C++.
//
// Re-designed counterpart of the reference's I/O core
// (reference src/brpc/event_dispatcher.cpp epoll loops,
//  input_messenger.cpp:60-129 cut loop, socket.cpp:1591-1686 write path,
//  baidu_rpc_protocol.cpp:92-668 parse/pack+dispatch).  NOT a port: one
// C-ABI surface over the tbutil IOBuf/pool primitives, driven from Python
// via ctypes.  The per-request path — readv, frame cut, CRC verify, method
// lookup, response pack, writev — never touches the Python interpreter for
// natively-registered methods; everything else routes to ONE Python
// callback per frame (the "process_request" boundary), and connections
// that speak a different protocol (HTTP portal, nshead...) are handed off
// to the Python plane wholesale after the first bytes are sniffed (the
// reference's server tries every registered protocol on a new connection
// the same way, input_messenger.cpp:60-129).
//
// Wire protocols spoken natively per connection (sniffed on the first 4
// bytes, fixed for the connection's lifetime):
//   * tbus_std — "TPRC" 32-byte header (protocol/tbus_std.py)
//   * baidu_std — "PRPC" 12-byte header + proto2 RpcMeta, the reference's
//     canonical protocol (baidu_rpc_protocol.cpp:53-58); the RpcMeta
//     varint/length-delimited codec is hand-rolled here, byte-compatible
//     with protocol/baidu_std.py.  Production-shaped frames stay native:
//     compress_type (snappy/gzip/zlib1 via the built-in codec table,
//     decompress on cut + floor-honoring recompress on pack) and
//     authentication_data (verified once per connection — constant-time
//     token table or registered verifier — rejects answered ERPCAUTH)
//     are handled here, byte-identical to the Python codecs, and so is
//     trace context: RpcRequestMeta fields 3/4/5/6 (log_id/trace_id/
//     span_id/parent_span_id, the reference's Dapper fields) plus the
//     head-based sampled bit (field 9, this stack's extension — see
//     docs/PARITY.md) decode on the cut path and ride the telemetry
//     record, so OBSERVED traffic stays on the fast path.  Frames
//     whose meta carries semantics the fast path doesn't implement
//     (stream settings, responses) route per-frame to
//     Python with flag bit 8 (0x100) set in the callback's `flags` so
//     the Python side decodes the meta as RpcMeta instead of JSON (bit
//     9, 0x200, marks a connection whose credential already verified
//     natively).
#ifndef TBNET_H
#define TBNET_H

#include <stddef.h>
#include <stdint.h>

#include "../tbutil/tbutil.h"

#ifdef __cplusplus
extern "C" {
#endif

typedef struct tb_server tb_server;
typedef struct tb_channel tb_channel;

// Per-frame Python route: meta/body of one request frame whose method is
// not natively registered (or that carries stream/response flags,
// compression, or JSON escapes).  Ownership of `body` (payload+attachment,
// meta already stripped) transfers to the callee — it must eventually
// tb_iobuf_destroy it.  Runs on a loop thread; must not block for long.
// `flags` bit 8 (0x100) marks a frame that arrived on a baidu_std (PRPC)
// connection: `meta` is then raw RpcMeta proto bytes, not JSON, and the
// callee answers with PRPC bytes via tb_conn_write.
typedef void (*tb_frame_fn)(void* ctx, uint64_t conn_token, uint32_t cid_lo,
                            uint32_t cid_hi, uint32_t flags,
                            uint32_t error_code, const char* meta,
                            size_t meta_len, tb_iobuf* body);

// Protocol-sniff handoff: the first bytes of a new connection are not
// tbus_std.  The callee takes ownership of `fd` and receives whatever was
// already buffered (copied; free'd by tbnet after the call returns).
typedef void (*tb_handoff_fn)(void* ctx, int fd, const void* buffered,
                              size_t len);

// A connection died (EOF, error, server stop).  The token is already stale
// when this fires; Python uses it to drop per-connection state (streams'
// on_failed hooks).  Not fired for handed-off connections.
typedef void (*tb_closed_fn)(void* ctx, uint64_t conn_token);

// Credential verifier (tb_server_set_auth): called ONCE per connection
// with the first frame's authentication_data (may be NULL/empty when the
// frame carried none) and the peer address.  Return 0 to accept; any
// other value rejects the request with ERPCAUTH (the connection stays
// open and may retry with a fresh credential).  Runs on a loop thread —
// a Python trampoline here costs one GIL crossing per CONNECTION, not
// per request (the verdict caches on the conn).
typedef int (*tb_auth_fn)(void* ud, const char* auth_data, size_t auth_len,
                          const char* peer_ip, int peer_port);

// One completion record per natively-dispatched request (the telemetry
// ring's element; see tb_server_set_telemetry).  Field layout is ABI —
// 64 bytes, checked THREE ways (this header, the ctypes.Structure in
// transport/native_plane.py, and the numpy drain dtype) by fabriclint's
// ffi-struct pass.
typedef struct {
  uint32_t method_idx;      // index into the server's native method table
  uint32_t error_code;      // 0 = success (ELIMIT for admission refusals)
  uint64_t start_ns;        // CLOCK_MONOTONIC at dispatch entry
  uint64_t latency_ns;      // dispatch entry -> response queued
  uint64_t correlation_id;
  uint32_t request_size;    // payload + attachment bytes
  uint32_t response_size;   // payload + attachment bytes (0 on error)
  // bit 0: rpcz sample election (counter-based 1/N, OR wire-forced);
  // bits 1-2: request codec id; bit 3: the sampled bit arrived ON THE
  // WIRE (head-based coherent sampling — the edge's decision, which
  // overrides the local 1/N election)
  uint32_t sampled;
  uint32_t reactor_id;      // reactor that cut/dispatched the request
  // wire-propagated trace context (RpcRequestMeta fields 4/5; 0 = the
  // request carried none): the drain parents this hop's server span
  // into the CALLER's trace instead of minting a fresh one
  uint64_t trace_id;
  uint64_t span_id;
} tb_telemetry_record;

// ---- server ----
// `nloops` is the reactor count: each reactor owns its own epoll fd, loop
// thread, listener (SO_REUSEPORT when nloops > 1), telemetry ring, and
// reusable cut/pack buffers.  Accepted connections are sharded round-robin
// across reactors at accept time and never migrate — the frame-cutter →
// decode → dispatch → pack hot path crosses zero cross-reactor locks.
tb_server* tb_server_create(int nloops);
// Reactor count this server was created with (>= 1).
int tb_server_num_reactors(const tb_server* s);
// Enable the per-port completion-record ring: every natively dispatched
// request appends ONE tb_telemetry_record into a lock-free MPSC ring of
// `capacity` slots (rounded up to a power of two); when the ring is full
// the record is dropped and a counter incremented — the hot path never
// blocks on the observer.  Every sample_every'th record (counter-based,
// 0 = never) carries sampled=1, the rpcz span election.  Call BEFORE
// tb_server_listen; later calls are ignored.  capacity 0 = disabled.
void tb_server_set_telemetry(tb_server* s, uint32_t capacity,
                             uint32_t sample_every);
// Pop up to max_records completed records into `out`; returns the count
// RETURNED, which can be less than what was popped (clock-invalid
// records are discarded and counted as dropped) — callers must drain
// until 0, not until a short batch.  Safe against concurrent loop-thread
// producers; drains race each other safely but the Python side still
// serializes them (single consumer).  Walks every reactor's ring; use
// tb_server_drain_telemetry_ring to drain one reactor's ring in
// per-reactor batches (the vectorized drain's shape).
long tb_server_drain_telemetry(tb_server* s, tb_telemetry_record* out,
                               size_t max_records);
// Drain ONE reactor's completion ring (reactor in [0, num_reactors)).
// Same return/drain-until-0 contract as tb_server_drain_telemetry;
// -1 for an out-of-range reactor.
long tb_server_drain_telemetry_ring(tb_server* s, int reactor,
                                    tb_telemetry_record* out,
                                    size_t max_records);
// Records lost: ring overflow + clock-invalid discards at drain
// (0 when telemetry is disabled).  Summed across every reactor's ring.
uint64_t tb_server_telemetry_dropped(const tb_server* s);
// Per-reactor counters (reactor in [0, num_reactors)): live connections
// owned by the reactor, requests it dispatched natively, and its
// telemetry ring's drop count.  0 ok, -1 out of range.  Any thread.
int tb_server_reactor_stats(const tb_server* s, int reactor,
                            uint64_t* live_conns, uint64_t* native_reqs,
                            uint64_t* telemetry_dropped);
void tb_server_set_frame_cb(tb_server* s, tb_frame_fn cb, void* ctx);
void tb_server_set_handoff_cb(tb_server* s, tb_handoff_fn cb, void* ctx);
void tb_server_set_closed_cb(tb_server* s, tb_closed_fn cb, void* ctx);
void tb_server_set_max_body(tb_server* s, size_t bytes);
// Response-compression floor (native_compress_min_bytes): a PRPC request
// that arrived compressed gets its response recompressed with the same
// codec ONLY when the payload has at least this many bytes — tiny
// payloads answer uncompressed, matching the Python route's floor so the
// planes stay byte-identical.  0 = always recompress.
void tb_server_set_compress_min_bytes(tb_server* s, size_t bytes);
// Decompressed-size ceiling (max_decompress_bytes): a compressed request
// whose payload would expand past this is rejected EREQUEST instead of
// expanding into server memory (0 = unlimited; default 256 MiB).
void tb_server_set_max_decompress(tb_server* s, size_t bytes);
// Install a credential verifier: PRPC frames carrying
// authentication_data are verified natively (once per connection,
// verdict cached) and rejects answered ERPCAUTH byte-identically to the
// Python route.  Pre-listen only (0 ok, -1 after listen).
int tb_server_set_auth(tb_server* s, tb_auth_fn fn, void* ud);
// Constant-time token table (the default trampoline): blob is repeated
// [u32 LE length][bytes] records; a credential equal to ANY token
// verifies — entirely in C, so authenticated steady-state traffic never
// enters the interpreter.  Replaces the previous table.  Pre-listen only
// (0 ok, -1 after listen or on a malformed blob).
int tb_server_set_auth_tokens(tb_server* s, const char* blob,
                              size_t blob_len);
// Requests rejected ERPCAUTH by the native auth seam (the
// native_auth_rejects bvar feed).
uint64_t tb_server_auth_rejects(const tb_server* s);
// Compressed-traffic byte counters: request wire (compressed) and raw
// (decompressed) bytes in, response raw and wire bytes out — the
// native_compress_bytes_saved feed.  Any thread.
void tb_server_compress_stats(const tb_server* s, uint64_t* in_wire,
                              uint64_t* in_raw, uint64_t* out_raw,
                              uint64_t* out_wire);
// kind: 1 = echo (respond with the request body), 2 = nop (empty response).
// max_concurrency 0 = unlimited; exceeding it answers ELIMIT natively.
// runtime retune of a native method's admission limit (0 = unlimited)
int tb_server_set_native_max_concurrency(tb_server* s, const char* full_name,
                                         uint32_t max_concurrency);
long tb_server_get_native_max_concurrency(tb_server* s,
                                          const char* full_name);
int tb_server_register_native(tb_server* s, const char* full_name, int kind,
                              uint32_t max_concurrency);
// User native method: bytes-in/bytes-out C callback, run entirely on the
// loop thread — the request never crosses into Python (the reference's
// whole ProcessRpcRequest/user-code/SendRpcResponse round is native,
// baidu_rpc_protocol.cpp:307-503; this is that generality for tbnet).
// Contract: `req` is the contiguous request payload (attachment included,
// valid only during the call); on success (return 0) the callee mallocs
// *resp (may be NULL when *resp_len==0) and tbnet free()s it after the
// response is queued.  A nonzero return becomes the response error_code.
// Must not block — it runs on the connection's event loop — and MUST be
// thread-safe: connections are round-robined across loops, so the same
// callback runs concurrently on multiple loop threads.
typedef int (*tb_native_fn)(void* ud, const char* req, size_t req_len,
                            char** resp, size_t* resp_len);
int tb_server_register_native_fn(tb_server* s, const char* full_name,
                                 tb_native_fn fn, void* ud,
                                 uint32_t max_concurrency);
// Work-stealing dispatch pool: `nworkers` threads, each reactor owning a
// Chase–Lev deque the workers steal from when their preferred deque runs
// empty.  User methods (tb_server_register_native_fn kinds) flagged
// long-running — or arriving behind a queue-depth-pressured burst —
// defer to the pool so one slow handler can't stall its reactor's
// cut/pack work; fast methods stay inline on the loop thread.  Call
// BEFORE tb_server_listen (0 disables; returns -1 after listen).
int tb_server_set_dispatch_pool(tb_server* s, int nworkers);
// Mark a registered user method long-running: with a dispatch pool
// enabled its requests always defer to the pool.  0 ok, -1 unknown
// method.  Runtime-safe (loop threads read the flag per request).
int tb_server_set_native_long_running(tb_server* s, const char* full_name,
                                      int on);
// listen on ip:port (port 0 = ephemeral); returns the bound port or -errno.
int tb_server_listen(tb_server* s, const char* ip, int port);
int tb_server_port(const tb_server* s);
// stop accepting, fail every connection, join the loop threads.
void tb_server_stop(tb_server* s);
void tb_server_destroy(tb_server* s);
void tb_server_stats(const tb_server* s, uint64_t* accepted,
                     uint64_t* native_reqs, uint64_t* cb_frames,
                     uint64_t* handoffs, uint64_t* live_conns);
// Requests answered EDEADLINE because their propagated deadline (RpcMeta
// timeout_ms / JSON meta timeout_ms) expired before dispatch — the
// native plane's feed for the deadline_shed_count bvar.
uint64_t tb_server_deadline_sheds(const tb_server* s);
// Lame-duck: stop accepting NEW connections while existing ones keep
// being served.  Asynchronous and reactor-aware — EVERY reactor tears
// down its own listener on its own loop thread at its next wakeup
// (sub-ms).  Irreversible for this server; tb_server_stop still performs
// the full teardown.
void tb_server_pause_accept(tb_server* s);
// Close every connection idle (no readable burst) for >= idle_ms,
// across every reactor's connection list.  Thread-safe (shutdown(); the
// owning reactor reaps via EPOLLHUP — the tb_conn_close discipline).
// Returns the number of connections culled.
long tb_server_close_idle(tb_server* s, uint64_t idle_ms);

// ---- per-connection surface (used by the Python frame route) ----
// Queue a tbus_std response frame on the connection (tbus_std conns only;
// the Python route answers baidu_std conns with pre-packed PRPC bytes
// through tb_conn_write). 0 ok, -1 stale token.
int tb_conn_respond(uint64_t token, const void* meta, size_t meta_len,
                    const void* payload, size_t payload_len,
                    const void* att, size_t att_len, uint32_t cid_lo,
                    uint32_t cid_hi, uint32_t flags, uint32_t error_code);
// Queue arbitrary pre-framed bytes (stream frames, feedback). Consumes
// nothing from `data` (refs are shared). 0 ok, -1 stale token.
int tb_conn_write(uint64_t token, const tb_iobuf* data);
// Peer address. Returns port (>=0) and fills ip (textual), or -1.
int tb_conn_peer(uint64_t token, char* ip_out, size_t ip_cap);
// Fail + close the connection (0 ok, -1 stale).
int tb_conn_close(uint64_t token);
// Cache a Python-route auth verdict on the connection: its later frames
// ride the native fast path without re-fighting the credential (0 ok,
// -1 stale token).
int tb_conn_set_authenticated(uint64_t token);

// ---- client channel ----
// Blocking connect with timeout; NULL on failure (*err_out = errno).
// Every channel pins to a client reactor shard at connect (round-robin
// over a process-global counter): the correlation-id space is
// partitioned per shard — the top 8 bits of every cid the channel mints
// carry its shard id, so completions route back to the owning channel's
// pending table with NO shared cross-channel map, and a response whose
// cid names a different shard is detectably misrouted (see
// tb_channel_cid_misroutes) instead of silently corrupting a wait.
tb_channel* tb_channel_connect(const char* ip, int port, int timeout_ms,
                               int* err_out);
// The client reactor shard this channel pinned at connect (>= 0).
int tb_channel_reactor(const tb_channel* ch);
// Responses observed with a WRONG shard tag in their correlation id.
// Each one is counted, re-tagged to the local shard, and — when a
// pending call with the same sequence exists — completes that call with
// -EBADMSG (the Python plane surfaces it as EREQUEST); the channel
// itself survives.
uint64_t tb_channel_cid_misroutes(const tb_channel* ch);
// Select the channel's wire protocol BEFORE the first send: 0 = tbus_std
// (default), 1 = baidu_std (PRPC).  In baidu_std mode the `meta` argument
// of call/send/pump is the pre-encoded RpcRequestMeta SUBMESSAGE
// (service_name/method_name/...); the channel wraps it into a full
// RpcMeta, splicing in its own correlation_id and attachment_size, so the
// emitted frames are byte-identical to protocol/baidu_std.py's
// pack_request.  meta_out of call/recv receives the raw response RpcMeta
// proto bytes (decode on the Python side); err_code_out carries the
// RpcResponseMeta error_code.  Returns 0, or -1 for an unknown protocol.
int tb_channel_set_protocol(tb_channel* ch, int proto);
// Channel-default request compress_type (baidu_std RpcMeta field 3,
// values 0-3 per options.proto).  The CALLER compresses payloads with
// the matching codec before call/send/pump — this stamps the wire field
// only.  In baidu_std mode the low 4 bits of call/send's flags_extra
// override it per call.  Set before concurrent use.  0 ok, -1 bad value.
int tb_channel_set_compress(tb_channel* ch, int compress_type);
// Credential for RpcMeta field 7 (authentication_data), stamped on every
// request until the first successful response proves the connection —
// the reference's first-request auth fight.  NULL/0 clears.  Set before
// concurrent use.  Returns 0.
int tb_channel_set_auth(tb_channel* ch, const void* data, size_t len);
// Ambient trace context for the pipelined pump (tb_channel_pump):
// every `every`'th frame of a pump carries the trace fields in its
// RpcRequestMeta (3 log_id / 4 trace_id / 5 span_id / 6 parent_span_id
// / 9 sampled) — counter-scheduled exact-rate like the fault seam, so a
// traced flood is one call.  Per traced frame the span_id is
// `span_id + sequence` (patched in the pump's fixed-width template), so
// every traced request is its own child span of `parent_span_id`.
// `every` 0 disables; 1 = every frame.  baidu_std channels only (the
// tbus pump meta is caller-built); set before concurrent use.
// Returns 0, or -1 on a tbus_std channel with every != 0.
int tb_channel_set_trace(tb_channel* ch, uint64_t log_id, uint64_t trace_id,
                         uint64_t span_id, uint64_t parent_span_id,
                         int sampled, uint32_t every);
// Counter-scheduled client-side fault injection (the native analog of
// the Python Socket.write seam, rpc/fault_injector.py): every
// fail_every'th tb_channel_call answers err_code (0 -> EINTERNAL)
// without touching the wire, every close_every'th kills the connection
// mid-run, every delay_every'th sleeps delay_ms first.  0 disables a
// schedule; set before issuing concurrent calls.  Returns 0.
int tb_channel_set_fault(tb_channel* ch, uint32_t fail_every,
                         uint32_t close_every, uint32_t delay_every,
                         uint32_t delay_ms, uint32_t err_code);
// Synchronous call over the shared connection.  Thread-safe: concurrent
// callers elect one reader which pumps completions for everyone (the
// single-connection multi-caller shape of the reference's client,
// socket.cpp write queue + cid wakeups).  Returns body length (>=0) or
// -errno (-ETIMEDOUT, -EPIPE, -EPROTO...).  body_out receives
// payload+attachment; resp meta (JSON) is copied into meta_out.
long tb_channel_call(tb_channel* ch, const void* meta, size_t meta_len,
                     const void* payload, size_t payload_len,
                     const void* att, size_t att_len, uint32_t flags_extra,
                     tb_iobuf* body_out, void* meta_out, size_t meta_cap,
                     uint32_t* meta_len_out, uint32_t* err_code_out,
                     int timeout_ms);
// Pipelined surface: send returns the frame's cid (>0) or 0 on error
// (*err_out = errno); recv returns the body length of ONE completed
// send()-originated frame (filling cid_out/meta/err_code) or -errno.
uint64_t tb_channel_send(tb_channel* ch, const void* meta, size_t meta_len,
                         const void* payload, size_t payload_len,
                         const void* att, size_t att_len,
                         uint32_t flags_extra, int* err_out);
long tb_channel_recv(tb_channel* ch, uint64_t* cid_out, tb_iobuf* body_out,
                     void* meta_out, size_t meta_cap, uint32_t* meta_len_out,
                     uint32_t* err_code_out, int timeout_ms);
// Sticky failure code (0 = healthy).
int tb_channel_error(const tb_channel* ch);
void tb_channel_destroy(tb_channel* ch);

// Native perf harness (the example/rdma_performance client analog; the
// Python rpc_press tool drives the same shape from the interpreter):
// issue `n` requests keeping `inflight` outstanding on this connection,
// entirely in C++.  Requires exclusive use of the channel for the call's
// duration (takes both the writer and reader roles).  Returns ns/request,
// or -errno.
long tb_channel_pump(tb_channel* ch, const void* meta, size_t meta_len,
                     const void* payload, size_t payload_len, int n,
                     int inflight, int timeout_ms);

// ---- codec table (the native compress/auth seam's codecs, exported) ----
// codec: 1 = snappy (block format), 2 = gzip (deterministic container,
// mtime=0), 3 = zlib level 1.  Appends the result to `out` and returns
// the byte count, or negative: -1 corrupt input, -2 output beyond
// max_out (decompress only; 0 = unlimited), -3 unknown codec.  Any
// thread (per-thread codec state).  protocol/compress.py prefers these
// over its pure-Python twins so BOTH planes run the identical codec.
long tb_codec_compress(int codec, const void* in, size_t in_len,
                       tb_iobuf* out);
long tb_codec_decompress(int codec, const void* in, size_t in_len,
                         size_t max_out, tb_iobuf* out);

// ---- RpcMeta scanner (differential-testing surface) ----
// Runs the SAME proto2 scanner the server cut path and the client pump
// run over one RpcMeta blob, so tests can feed identical bytes to this
// and to protocol/baidu_std.py's decoder and diff the verdicts.
// Returns -1 when the scanner rejects (the connection-kill path), -2
// when a decoded service/method name exceeds its caller cap, else a
// flags bitmask: bit 0 = fields beyond the native fast path's scope
// (the frame would route to Python), bit 1 = response meta.  On accept
// every out-param is filled (names copied raw — they may contain NULs;
// read *svc_len_out/*mth_len_out, not strlen).  The trace out-params
// carry RpcRequestMeta fields 3/4/5/6 (+ the field-9 sampled bit) so
// the wire-differential fuzz diffs the trace decode too.  Diagnostic
// surface, not a hot path.
long tb_scan_prpc_meta(const void* meta, size_t meta_len,
                       uint64_t* cid_out, long* attachment_out,
                       long* timeout_ms_out, uint32_t* compress_out,
                       uint32_t* error_code_out,
                       char* svc_out, size_t svc_cap, size_t* svc_len_out,
                       char* mth_out, size_t mth_cap, size_t* mth_len_out,
                       uint64_t* log_id_out, uint64_t* trace_id_out,
                       uint64_t* span_id_out, uint64_t* parent_span_id_out,
                       uint32_t* sampled_out);

// ---- work-stealing deque (Chase–Lev) ----
// The dispatch pool's per-reactor queue, exported standalone so the
// TSAN stress (and any future native scheduler) can drive it directly:
// ONE owner thread pushes/pops the bottom, any number of thieves steal
// the top.  Values are opaque u64 (the server stores task pointers).
typedef struct tb_wsq tb_wsq;
// capacity is rounded up to a power of two (min 64).
tb_wsq* tb_wsq_create(size_t capacity);
void tb_wsq_destroy(tb_wsq* q);
// Owner-only: 0 ok, -1 full (caller runs the work inline — backpressure,
// never blocking).
int tb_wsq_push(tb_wsq* q, uint64_t value);
// Owner-only: 1 = popped into *out, 0 = empty.
int tb_wsq_pop(tb_wsq* q, uint64_t* out);
// Any thread: 1 = stolen into *out, 0 = empty or lost the race (retry).
int tb_wsq_steal(tb_wsq* q, uint64_t* out);
// Approximate outstanding count (owner's view; racy by design).
long tb_wsq_size(const tb_wsq* q);

#ifdef __cplusplus
}
#endif
#endif  // TBNET_H
