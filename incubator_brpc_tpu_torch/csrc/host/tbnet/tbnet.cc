// tbnet — native network plane implementation.  See tbnet.h for the role
// and the reference seams this re-designs (event_dispatcher.cpp,
// input_messenger.cpp:60-129, socket.cpp:1591-1686, baidu_rpc_protocol.cpp).
//
// Threading model: N epoll loop threads own connections (a connection is
// read by exactly its loop thread; LT events, no oneshot re-arm needed).
// Foreign threads (Python handlers answering asynchronously, the client's
// writers) touch a connection only through versioned tokens resolved out
// of a tb_respool — the same Address-after-SetFailed discipline the
// reference builds on Socket's versioned refs (socket.h:619-630).  Writes
// from any thread serialize on the connection's write mutex; the fd is
// closed only after every in-flight token holder drops its ref.

#include "tbnet.h"

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>  // crc32: the dispatch key's second polynomial

#if defined(__x86_64__)
#include <x86intrin.h>  // __rdtsc: the telemetry hot path's cheap clock
#endif

namespace {

// wire constants — must match protocol/tbus_std.py and tbutil.cc
constexpr uint32_t kMagic = 0x54505243;  // "TPRC"
constexpr uint32_t kFlagResponse = 1;
constexpr uint32_t kFlagStream = 2;
constexpr uint32_t kFlagHasMeta = 4;
constexpr uint32_t kFlagBodyCrc = 8;
// internal-only callback flag: the frame arrived on a baidu_std (PRPC)
// connection and its meta is raw RpcMeta proto bytes (never on the wire;
// must stay out of the tbus_std wire-flag space above)
constexpr uint32_t kFlagWirePrpc = 0x100;
// internal-only callback flag: the connection's credential was already
// verified on the native plane — the Python route's server_check must
// honor the cached verdict instead of demanding the credential again
constexpr uint32_t kFlagConnAuthed = 0x200;
constexpr size_t kHeader = 32;

// baidu_std: "PRPC" + body_size(u32 BE) + meta_size(u32 BE)
// (protocol/baidu_std.py; reference baidu_rpc_protocol.cpp:53-58)
constexpr uint32_t kMagicPrpc = 0x43505250;  // "PRPC" read as LE u32
constexpr size_t kPrpcHeader = 12;

// connection wire protocol, fixed at sniff time
constexpr int kProtoTbus = 1;
constexpr int kProtoPrpc = 2;

constexpr int kKindEcho = 1;
constexpr int kKindNop = 2;
constexpr int kKindCallback = 3;  // user C fn: tb_server_register_native_fn

uint64_t now_ms() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::milliseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

// ---------------------------------------------------------------------------
// minimal JSON scanner for the flat meta object.  The native plane needs
// only the routing fields (service/method/attachment_size); any meta it
// cannot fully vouch for (escapes, compression, stream/trace fields, parse
// trouble) routes to the Python frame callback, which parses properly.
// ---------------------------------------------------------------------------

struct MetaLite {
  bool ok = false;         // meta parsed cleanly
  bool to_python = false;  // fields beyond the native fast path's scope
  std::string service;
  std::string method;
  long attachment = 0;
  long timeout_ms = 0;  // propagated deadline budget (0 = none)
  // Dapper trace context (same keys as protocol/tbus_std.py Meta):
  // decoded natively so OBSERVED tbus traffic keeps the fast path
  uint64_t log_id = 0;
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  uint64_t parent_span_id = 0;
  uint32_t sampled = 0;  // head-based coherent-sampling bit ("sampled":1)
};

struct Scan {
  const char* p;
  const char* end;
  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool lit(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    return false;
  }
  // raw string body between quotes; *escaped set if any backslash seen
  bool str(std::string* out, bool* escaped) {
    ws();
    if (p >= end || *p != '"') return false;
    ++p;
    const char* s = p;
    bool esc = false;
    while (p < end) {
      if (*p == '\\') {
        esc = true;
        p += 2;
        continue;
      }
      if (*p == '"') {
        if (out) out->assign(s, p - s);
        if (escaped) *escaped = esc;
        ++p;
        return true;
      }
      ++p;
    }
    return false;
  }
  bool skip_value();
  bool skip_container(char open, char close) {
    int depth = 1;
    ++p;  // past open
    while (p < end && depth > 0) {
      if (*p == '"') {
        if (!str(nullptr, nullptr)) return false;
        continue;
      }
      if (*p == open) ++depth;
      if (*p == close) --depth;
      ++p;
    }
    return depth == 0;
  }
};

bool Scan::skip_value() {
  ws();
  if (p >= end) return false;
  char c = *p;
  if (c == '"') return str(nullptr, nullptr);
  if (c == '{') return skip_container('{', '}');
  if (c == '[') return skip_container('[', ']');
  const char* s = p;  // number / true / false / null
  while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != ' ' &&
         *p != '\t' && *p != '\n' && *p != '\r')
    ++p;
  return p > s;
}

MetaLite scan_meta(const char* s, size_t n) {
  MetaLite m;
  if (n == 0) {
    m.ok = true;
    return m;
  }
  Scan sc{s, s + n};
  if (!sc.lit('{')) return m;
  sc.ws();
  if (sc.p < sc.end && *sc.p == '}') {
    m.ok = true;
    return m;
  }
  for (;;) {
    std::string key;
    bool kesc = false;
    if (!sc.str(&key, &kesc) || kesc) return m;
    if (!sc.lit(':')) return m;
    if (key == "service" || key == "method") {
      std::string v;
      bool vesc = false;
      if (!sc.str(&v, &vesc)) return m;
      if (vesc) m.to_python = true;  // escaped name: Python unescapes
      (key == "service" ? m.service : m.method) = std::move(v);
    } else if (key == "attachment_size") {
      sc.ws();
      char* endp = nullptr;
      m.attachment = strtol(sc.p, &endp, 10);
      if (endp == sc.p || m.attachment < 0) return m;
      sc.p = endp;
    } else if (key == "timeout_ms") {
      // the propagated deadline is native-fast-path territory: the
      // cutter sheds expired work itself (run_native), so a deadline-
      // carrying frame must NOT fall off the interpreter-free plane
      sc.ws();
      char* endp = nullptr;
      m.timeout_ms = strtol(sc.p, &endp, 10);
      if (endp == sc.p || m.timeout_ms < 0) return m;
      sc.p = endp;
    } else if (key == "log_id" || key == "trace_id" || key == "span_id" ||
               key == "parent_span_id" || key == "sampled") {
      // trace context is native-fast-path territory too: observed
      // traffic must not pay the interpreter tax (ROADMAP item 1) —
      // the ids ride the telemetry record, the sampled bit is the
      // head-based coherent-sampling election
      sc.ws();
      if (sc.p >= sc.end || *sc.p == '-') {
        m.to_python = true;  // negative/odd ids: Python owns the edge case
        if (!sc.skip_value()) return m;
      } else {
        char* endp = nullptr;
        uint64_t v = strtoull(sc.p, &endp, 10);
        if (endp == sc.p) return m;
        sc.p = endp;
        if (key == "log_id") m.log_id = v;
        else if (key == "trace_id") m.trace_id = v;
        else if (key == "span_id") m.span_id = v;
        else if (key == "parent_span_id") m.parent_span_id = v;
        else m.sampled = v != 0 ? 1u : 0u;
      }
    } else {
      // compress, stream ids, error_text, extra...: semantics the
      // native fast path doesn't implement — Python handles them
      if (!sc.skip_value()) return m;
      m.to_python = true;
    }
    sc.ws();
    if (sc.p < sc.end && *sc.p == ',') {
      ++sc.p;
      continue;
    }
    if (sc.lit('}')) break;
    return m;
  }
  m.ok = true;
  return m;
}

// ---------------------------------------------------------------------------
// baidu_std (PRPC): hand-rolled proto2 wire codec for RpcMeta — varint +
// length-delimited only, the exact field tables of protocol/baidu_std.py
// (policy/baidu_rpc_meta.proto):
//   RpcMeta:        1 request(msg)  2 response(msg)  3 compress_type
//                   4 correlation_id  5 attachment_size
//                   7 authentication_data  8 stream_settings(msg)
//   RpcRequestMeta: 1 service_name  2 method_name  3 log_id  4 trace_id
//                   5 span_id  6 parent_span_id  8 timeout_ms
//                   9 traced_sampled (this stack's extension — the
//                     head-based coherent-sampling bit; docs/PARITY.md)
//   RpcResponseMeta: 1 error_code  2 error_text
// Same routing philosophy as the JSON scanner above: the native fast path
// vouches for service/method/cid/attachment_size, the propagated deadline,
// compression, auth, AND the Dapper trace fields; anything else (streams,
// unknown fields) routes to Python, which implements the full semantics.
// ---------------------------------------------------------------------------

size_t varint_len(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++n;
  }
  return n;
}

size_t put_varint(uint8_t* out, uint64_t v) {
  size_t n = 0;
  while (v >= 0x80) {
    out[n++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  out[n++] = static_cast<uint8_t>(v);
  return n;
}

// fixed 10-byte (padded) varint: value-independent length so the pump's
// frame template can patch the correlation id in place.  Decoders accept
// non-minimal varints (protocol/baidu_std.py _read_varint reads through
// shift 63), so the bytes stay wire-legal.
void put_varint_fixed10(uint8_t* out, uint64_t v) {
  for (int i = 0; i < 9; ++i)
    out[i] = static_cast<uint8_t>((v >> (7 * i)) & 0x7F) | 0x80;
  out[9] = static_cast<uint8_t>((v >> 63) & 0x7F);
}

// bounded varint read; false on truncation/overlong
bool read_varint(const uint8_t* p, size_t n, size_t* off, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (*off < n && shift <= 63) {
    uint8_t b = p[*off];
    ++*off;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if ((b & 0x80) == 0) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

struct PrpcMeta {
  bool ok = false;         // meta parsed cleanly
  bool to_python = false;  // fields beyond the native fast path's scope
  bool is_response = false;
  const char* svc = nullptr;
  size_t svc_len = 0;
  const char* mth = nullptr;
  size_t mth_len = 0;
  // the RpcRequestMeta submessage slice — the per-connection routing memo
  // key (byte-identical submessage => same method)
  const char* req_sub = nullptr;
  size_t req_sub_len = 0;
  uint64_t cid = 0;
  long attachment = 0;
  long timeout_ms = 0;  // RpcRequestMeta.timeout_ms (field 8); 0 = none
  // Dapper trace context (RpcRequestMeta fields 3-6) + the field-9
  // sampled bit: decoded natively so traced frames keep the fast path;
  // the ids ride the telemetry record, the bit overrides 1/N election
  uint64_t log_id = 0;
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  uint64_t parent_span_id = 0;
  uint32_t sampled = 0;
  uint32_t error_code = 0;
  // compress_type (field 3): dispatched through the native codec table —
  // out-of-enum values stay here too (run_native answers the clean
  // unknown-codec EREQUEST byte-identically to the Python route)
  uint32_t compress = 0;
  // authentication_data (field 7): verified natively once per connection
  const char* auth = nullptr;
  size_t auth_len = 0;
};

PrpcMeta scan_prpc_meta(const char* s, size_t n) {
  PrpcMeta m;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(s);
  size_t off = 0;
  while (off < n) {
    uint64_t key = 0;
    if (!read_varint(p, n, &off, &key)) return m;
    uint64_t field = key >> 3;
    int wt = static_cast<int>(key & 7);
    if (wt == 0) {
      uint64_t v = 0;
      if (!read_varint(p, n, &off, &v)) return m;
      if (field == 3) {  // compress_type: the native codec table owns it
        if (v > 0xFFFFFFFFull) return m;
        m.compress = static_cast<uint32_t>(v);
      } else if (field == 4) {
        m.cid = v;
      } else if (field == 5) {
        if (v > (1ull << 31)) return m;
        m.attachment = static_cast<long>(v);
      } else {
        m.to_python = true;
      }
    } else if (wt == 2) {
      uint64_t len = 0;
      // subtraction form: `off + len > n` would wrap on an attacker-
      // supplied 64-bit length and defeat the bounds check entirely
      if (!read_varint(p, n, &off, &len) || len > n - off) return m;
      const char* sub = s + off;
      size_t sub_len = static_cast<size_t>(len);
      off += sub_len;
      if (field == 1) {  // RpcRequestMeta
        m.req_sub = sub;
        m.req_sub_len = sub_len;
        const uint8_t* q = reinterpret_cast<const uint8_t*>(sub);
        size_t qoff = 0;
        while (qoff < sub_len) {
          uint64_t k2 = 0;
          if (!read_varint(q, sub_len, &qoff, &k2)) return m;
          uint64_t f2 = k2 >> 3;
          int w2 = static_cast<int>(k2 & 7);
          if (w2 == 2) {
            uint64_t l2 = 0;
            if (!read_varint(q, sub_len, &qoff, &l2) || l2 > sub_len - qoff)
              return m;
            if (f2 == 1) {
              m.svc = sub + qoff;
              m.svc_len = static_cast<size_t>(l2);
            } else if (f2 == 2) {
              m.mth = sub + qoff;
              m.mth_len = static_cast<size_t>(l2);
            } else {
              m.to_python = true;
            }
            qoff += static_cast<size_t>(l2);
          } else if (w2 == 0) {
            uint64_t v2 = 0;
            if (!read_varint(q, sub_len, &qoff, &v2)) return m;
            if (f2 == 8) {
              // timeout_ms: the deadline shed runs natively (run_native)
              if (v2 > (1ull << 31)) return m;
              m.timeout_ms = static_cast<long>(v2);
            } else if (f2 == 3) {  // log_id
              m.log_id = v2;
            } else if (f2 == 4) {  // trace_id: the caller's trace
              m.trace_id = v2;
            } else if (f2 == 5) {  // span_id: the server span's parent
              m.span_id = v2;
            } else if (f2 == 6) {  // parent_span_id
              m.parent_span_id = v2;
            } else if (f2 == 9) {  // head-based sampled bit (extension)
              m.sampled = v2 != 0 ? 1u : 0u;
            } else if (v2 != 0) {
              m.to_python = true;  // unknown request-meta varint
            }
          } else if (w2 == 1 || w2 == 5) {
            size_t skip = w2 == 1 ? 8 : 4;
            if (qoff + skip > sub_len) return m;
            qoff += skip;
            m.to_python = true;
          } else {
            return m;
          }
        }
      } else if (field == 2) {  // RpcResponseMeta
        m.is_response = true;
        const uint8_t* q = reinterpret_cast<const uint8_t*>(sub);
        size_t qoff = 0;
        while (qoff < sub_len) {
          uint64_t k2 = 0;
          if (!read_varint(q, sub_len, &qoff, &k2)) return m;
          uint64_t f2 = k2 >> 3;
          int w2 = static_cast<int>(k2 & 7);
          if (w2 == 0) {
            uint64_t v2 = 0;
            if (!read_varint(q, sub_len, &qoff, &v2)) return m;
            if (f2 == 1) m.error_code = static_cast<uint32_t>(v2);
          } else if (w2 == 2) {
            uint64_t l2 = 0;
            if (!read_varint(q, sub_len, &qoff, &l2) || l2 > sub_len - qoff)
              return m;
            qoff += static_cast<size_t>(l2);  // error_text: Python decodes
          } else if (w2 == 1 || w2 == 5) {
            size_t skip = w2 == 1 ? 8 : 4;
            if (qoff + skip > sub_len) return m;
            qoff += skip;
          } else {
            return m;
          }
        }
      } else if (field == 7) {  // authentication_data: native auth seam
        m.auth = sub;
        m.auth_len = sub_len;
      } else {  // stream settings (8), unknown
        m.to_python = true;
      }
    } else if (wt == 1 || wt == 5) {
      // fixed64/fixed32: RpcMeta never uses them today, but they are
      // legal proto2 — skip and route to Python (which walks them the
      // same way) instead of killing the connection
      size_t skip = wt == 1 ? 8 : 4;
      if (off + skip > n) return m;
      off += skip;
      m.to_python = true;
    } else {
      return m;
    }
  }
  m.ok = true;
  return m;
}

// ---------------------------------------------------------------------------
// codecs — production-shaped PRPC traffic (compress_type field 3) stays on
// the native plane instead of falling off to the ~35 µs Python route.
// Wire ids follow options.proto CompressType as protocol/baidu_std.py maps
// them: 1 = snappy, 2 = gzip, 3 = zlib ("zlib1", level 1).
//
// snappy is the block format hand-rolled here AND mirrored line-for-line
// in protocol/snappy_codec.py: both encoders run the identical greedy
// parse (same hash, same skip schedule, same emit rules), so the two
// planes produce byte-identical compressed output — the planes' byte-
// identity discipline extended to codecs.  Any standard snappy decoder
// reads the output; this decoder reads any standard snappy stream.
// gzip/zlib go through zlib (already linked): the gzip container is the
// deterministic header protocol/compress.py emits (mtime=0, XFL=0,
// OS=255, raw deflate level 6) so response recompression byte-matches
// the Python codec there too.
// ---------------------------------------------------------------------------

constexpr uint32_t kCompressSnappy = 1;
constexpr uint32_t kCompressGzip = 2;
constexpr uint32_t kCompressZlib1 = 3;

const char* codec_name(uint32_t id) {
  switch (id) {
    case kCompressSnappy: return "snappy";
    case kCompressGzip: return "gzip";
    case kCompressZlib1: return "zlib1";
  }
  return "?";
}

uint32_t load32le(const uint8_t* p) {
  // explicit little-endian composition: the Python twin reads
  // int.from_bytes(data[i:i+4], "little"), and the hash must match
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

void put_uvarint(std::vector<uint8_t>& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(static_cast<uint8_t>(v) | 0x80);
    v >>= 7;
  }
  out.push_back(static_cast<uint8_t>(v));
}

// per-reactor snappy hash table: epoch-tagged slots so reuse never pays a
// per-request memset (a stale entry from an earlier compression carries a
// different epoch and reads as empty — invisible to the output bytes,
// which only depend on "present or not")
struct SnappyTable {
  std::vector<uint64_t> slots;  // (epoch << 32) | (pos + 1)  // fabricscan: owner(loop)
  uint32_t epoch = 0;  // fabricscan: owner(loop)
};

// hash-table index mask: the shift (>= 18) already caps every index
// below the table size, so masking is an identity on every input — it
// exists to make the bound explicit (and statically checkable) at the
// subscript itself.  Mask and allocation both derive from the same
// bits constant so they cannot diverge (the parity pass diffs the
// bits against snappy_codec.py's _MAX_TABLE).
constexpr uint32_t kSnappyTableBits = 14;
constexpr uint32_t kSnappyTableMask = (1u << kSnappyTableBits) - 1;

void snappy_emit_literal(std::vector<uint8_t>& out, const uint8_t* s,
                         size_t n) {
  if (n == 0) return;
  size_t n1 = n - 1;
  if (n1 < 60) {
    out.push_back(static_cast<uint8_t>(n1 << 2));
  } else if (n1 < 0x100) {
    out.push_back(60 << 2);
    out.push_back(static_cast<uint8_t>(n1));
  } else if (n1 < 0x10000) {
    out.push_back(61 << 2);
    out.push_back(static_cast<uint8_t>(n1));
    out.push_back(static_cast<uint8_t>(n1 >> 8));
  } else if (n1 < 0x1000000) {
    out.push_back(62 << 2);
    out.push_back(static_cast<uint8_t>(n1));
    out.push_back(static_cast<uint8_t>(n1 >> 8));
    out.push_back(static_cast<uint8_t>(n1 >> 16));
  } else {
    out.push_back(63 << 2);
    out.push_back(static_cast<uint8_t>(n1));
    out.push_back(static_cast<uint8_t>(n1 >> 8));
    out.push_back(static_cast<uint8_t>(n1 >> 16));
    out.push_back(static_cast<uint8_t>(n1 >> 24));
  }
  out.insert(out.end(), s, s + n);
}

void snappy_emit_copy2(std::vector<uint8_t>& out, size_t off, size_t len) {
  out.push_back(static_cast<uint8_t>(((len - 1) << 2) | 2));
  out.push_back(static_cast<uint8_t>(off));
  out.push_back(static_cast<uint8_t>(off >> 8));
}

void snappy_emit_copy(std::vector<uint8_t>& out, size_t off, size_t len) {
  // the standard 60/64 split keeps every tail element >= 4 long
  while (len >= 68) {
    snappy_emit_copy2(out, off, 64);
    len -= 64;
  }
  if (len > 64) {
    snappy_emit_copy2(out, off, 60);
    len -= 60;
  }
  if (len >= 12 || off >= 2048) {
    snappy_emit_copy2(out, off, len);
  } else {
    out.push_back(static_cast<uint8_t>(((off >> 8) << 5) |
                                       ((len - 4) << 2) | 1));
    out.push_back(static_cast<uint8_t>(off));
  }
}

// fabricscan: borrows(SnappyTable)
void snappy_compress_block(const uint8_t* data, size_t n,
                           std::vector<uint8_t>& out, SnappyTable& tbl) {
  out.clear();
  put_uvarint(out, n);
  if (n == 0) return;
  if (n < 4) {
    snappy_emit_literal(out, data, n);
    return;
  }
  size_t ts = 256;
  int shift = 24;  // 32 - log2(ts)
  while (ts < (1u << kSnappyTableBits) && ts < n) {
    ts <<= 1;
    --shift;
  }
  if (tbl.slots.size() < (1u << kSnappyTableBits))
    tbl.slots.assign(1u << kSnappyTableBits, 0);
  const uint64_t epoch = static_cast<uint64_t>(++tbl.epoch);
  size_t i = 0, lit = 0;
  uint32_t skip = 32;
  while (i + 4 <= n) {
    uint32_t h = (load32le(data + i) * 0x1E35A7BDu) >> shift;
    h &= kSnappyTableMask;  // identity: h < table size by construction
    uint64_t e = tbl.slots[h];
    tbl.slots[h] = (epoch << 32) | (i + 1);
    size_t cand = (e >> 32) == epoch ? static_cast<size_t>(
                                           (e & 0xFFFFFFFFu)) - 1
                                     : static_cast<size_t>(-1);
    if (cand != static_cast<size_t>(-1) && i - cand <= 0xFFFF &&
        memcmp(data + cand, data + i, 4) == 0) {
      snappy_emit_literal(out, data + lit, i - lit);
      size_t m = 4;
      while (i + m < n && data[cand + m] == data[i + m]) ++m;
      snappy_emit_copy(out, i - cand, m);
      i += m;
      lit = i;
      skip = 32;
    } else {
      i += skip >> 5;
      ++skip;
    }
  }
  snappy_emit_literal(out, data + lit, n - lit);
}

// 0 ok, -1 corrupt, -2 claimed/produced size beyond max_out
int snappy_decompress_block(const uint8_t* in, size_t n, size_t max_out,
                            std::vector<uint8_t>& out) {
  size_t off = 0;
  uint64_t ulen = 0;
  if (!read_varint(in, n, &off, &ulen)) return -1;
  if (ulen > max_out) return -2;
  out.clear();
  // the reserve is an optimization only: with the ceiling disabled a
  // hostile length claim must not turn into a giant up-front allocation
  // (the per-element bounds checks below still cap actual growth at the
  // input's real expansion)
  out.reserve(static_cast<size_t>(
      ulen < (1u << 20) ? ulen : (1u << 20)));
  while (off < n) {
    uint8_t tag = in[off++];
    if ((tag & 3) == 0) {  // literal
      size_t len = (tag >> 2) + 1;
      if (len > 60) {
        size_t nb = len - 60;  // 1..4 length bytes
        if (off + nb > n) return -1;
        len = 0;
        for (size_t k = 0; k < nb; ++k)
          len |= static_cast<size_t>(in[off + k]) << (8 * k);
        len += 1;
        off += nb;
      }
      if (off + len > n || out.size() + len > ulen) return -1;
      out.insert(out.end(), in + off, in + off + len);
      off += len;
    } else {  // copy
      size_t len, cop;
      if ((tag & 3) == 1) {
        if (off >= n) return -1;
        len = ((tag >> 2) & 7) + 4;
        cop = (static_cast<size_t>(tag >> 5) << 8) | in[off++];
      } else if ((tag & 3) == 2) {
        if (off + 2 > n) return -1;
        len = (tag >> 2) + 1;
        cop = in[off] | (static_cast<size_t>(in[off + 1]) << 8);
        off += 2;
      } else {
        if (off + 4 > n) return -1;
        len = (tag >> 2) + 1;
        cop = in[off] | (static_cast<size_t>(in[off + 1]) << 8) |
              (static_cast<size_t>(in[off + 2]) << 16) |
              (static_cast<size_t>(in[off + 3]) << 24);
        off += 4;
      }
      if (cop == 0 || cop > out.size() || out.size() + len > ulen) return -1;
      size_t start = out.size() - cop;
      for (size_t k = 0; k < len; ++k) out.push_back(out[start + k]);
    }
  }
  return out.size() == ulen ? 0 : -1;
}

// per-reactor codec context: reusable z_streams (deflateReset between
// responses — deflate state is ~256 KB of allocations an inline init per
// response would churn) + snappy table + the three scratch vectors the
// decompress/recompress round reuses.  One per reactor, plus throwaway
// instances on pool workers (off the reactor's hot path by definition).
struct ZCtx {
  SnappyTable snap;
  std::vector<uint8_t> dbuf;  // decompressed request payload  // fabricscan: owner(loop)
  std::vector<uint8_t> cbuf;  // recompressed response payload  // fabricscan: owner(loop)
  std::vector<uint8_t> abuf;  // request attachment staging  // fabricscan: owner(loop)
  std::vector<uint8_t> ibuf;  // contiguous compressed input staging  // fabricscan: owner(loop)
  z_stream defl_raw{};        // gzip body: raw deflate, level 6  // fabricscan: owner(loop)
  z_stream defl_zlib{};       // zlib1: zlib wrapper, level 1  // fabricscan: owner(loop)
  z_stream infl{};            // inflate, wbits swapped per container  // fabricscan: owner(loop)
  bool defl_raw_ok = false, defl_zlib_ok = false, infl_ok = false;  // fabricscan: owner(loop)
  ~ZCtx() {
    if (defl_raw_ok) deflateEnd(&defl_raw);
    if (defl_zlib_ok) deflateEnd(&defl_zlib);
    if (infl_ok) inflateEnd(&infl);
  }
};

// deterministic gzip container: the exact bytes protocol/compress.py's
// gzip codec (gzip.compress(data, 6, mtime=0) on CPython) emits — fixed
// header, raw deflate level 6 / memLevel 8, CRC32 + ISIZE trailer
// fabricscan: borrows(ZCtx)
int gzip_compress(ZCtx& z, const uint8_t* in, size_t n,
                  std::vector<uint8_t>& out) {
  if (!z.defl_raw_ok) {
    if (deflateInit2(&z.defl_raw, 6, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return -1;
    z.defl_raw_ok = true;
  } else {
    deflateReset(&z.defl_raw);
  }
  out.clear();
  static const uint8_t hdr[10] = {0x1f, 0x8b, 8, 0, 0, 0, 0, 0, 0, 0xff};
  out.insert(out.end(), hdr, hdr + 10);
  size_t bound = deflateBound(&z.defl_raw, static_cast<uLong>(n));
  size_t base = out.size();
  out.resize(base + bound);
  z.defl_raw.next_in = const_cast<Bytef*>(in);
  z.defl_raw.avail_in = static_cast<uInt>(n);
  z.defl_raw.next_out = out.data() + base;
  z.defl_raw.avail_out = static_cast<uInt>(bound);
  if (deflate(&z.defl_raw, Z_FINISH) != Z_STREAM_END) return -1;
  out.resize(base + (bound - z.defl_raw.avail_out));
  uint32_t crc = static_cast<uint32_t>(
      crc32(0, reinterpret_cast<const Bytef*>(in), static_cast<uInt>(n)));
  for (int k = 0; k < 4; ++k) out.push_back(static_cast<uint8_t>(crc >> (8 * k)));
  uint32_t isize = static_cast<uint32_t>(n);
  for (int k = 0; k < 4; ++k)
    out.push_back(static_cast<uint8_t>(isize >> (8 * k)));
  return 0;
}

// fabricscan: borrows(ZCtx)
int zlib1_compress(ZCtx& z, const uint8_t* in, size_t n,
                   std::vector<uint8_t>& out) {
  if (!z.defl_zlib_ok) {
    if (deflateInit2(&z.defl_zlib, 1, Z_DEFLATED, 15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return -1;
    z.defl_zlib_ok = true;
  } else {
    deflateReset(&z.defl_zlib);
  }
  out.clear();
  size_t bound = deflateBound(&z.defl_zlib, static_cast<uLong>(n));
  out.resize(bound);
  z.defl_zlib.next_in = const_cast<Bytef*>(in);
  z.defl_zlib.avail_in = static_cast<uInt>(n);
  z.defl_zlib.next_out = out.data();
  z.defl_zlib.avail_out = static_cast<uInt>(bound);
  if (deflate(&z.defl_zlib, Z_FINISH) != Z_STREAM_END) return -1;
  out.resize(bound - z.defl_zlib.avail_out);
  return 0;
}

// bounded inflate shared by gzip (wbits 31) and zlib1 (wbits 15):
// 0 ok, -1 corrupt/truncated/trailing-garbage, -2 output beyond max_out.
// Mirrors protocol/compress.py's bounded decompressobj discipline —
// including "one member, no trailing bytes" — so the planes agree on
// what parses.
// fabricscan: borrows(ZCtx)
int zlib_decompress(ZCtx& z, int wbits, const uint8_t* in, size_t n,
                    size_t max_out, std::vector<uint8_t>& out) {
  if (!z.infl_ok) {
    if (inflateInit2(&z.infl, wbits) != Z_OK) return -1;
    z.infl_ok = true;
  } else if (inflateReset2(&z.infl, wbits) != Z_OK) {
    return -1;
  }
  out.clear();
  z.infl.next_in = const_cast<Bytef*>(in);
  z.infl.avail_in = static_cast<uInt>(n);
  for (;;) {
    size_t base = out.size();
    if (base > max_out) return -2;
    // chunk = min(want, room + 1), computed without wrapping: with the
    // ceiling disabled max_out is SIZE_MAX and `room + 1` would wrap to
    // 0, starving inflate of output space forever
    size_t want = std::max<size_t>(n * 2 + 64, 16384);
    size_t room = max_out - base;
    size_t chunk = room >= want ? want : room + 1;
    out.resize(base + chunk);
    z.infl.next_out = out.data() + base;
    z.infl.avail_out = static_cast<uInt>(chunk);
    int rc = inflate(&z.infl, Z_NO_FLUSH);
    out.resize(base + (chunk - z.infl.avail_out));
    if (rc == Z_STREAM_END) break;
    if (rc != Z_OK && rc != Z_BUF_ERROR) return -1;
    if (out.size() > max_out) return -2;
    if (z.infl.avail_in == 0 && rc == Z_BUF_ERROR) return -1;  // truncated
    if (z.infl.avail_in == 0 && chunk == z.infl.avail_out) return -1;
  }
  if (out.size() > max_out) return -2;
  if (z.infl.avail_in != 0) return -1;  // trailing garbage
  return 0;
}

// 0 ok, -1 corrupt, -2 beyond max_out, -3 unknown codec id
// fabricscan: borrows(ZCtx)
int codec_decompress(ZCtx& z, uint32_t codec, const uint8_t* in, size_t n,
                     size_t max_out, std::vector<uint8_t>& out) {
  switch (codec) {
    case kCompressSnappy:
      return snappy_decompress_block(in, n, max_out, out);
    case kCompressGzip:
      return zlib_decompress(z, 15 + 16, in, n, max_out, out);
    case kCompressZlib1:
      return zlib_decompress(z, 15, in, n, max_out, out);
  }
  return -3;
}

// 0 ok (out filled), nonzero on codec trouble (caller sends uncompressed)
// fabricscan: borrows(ZCtx)
int codec_compress(ZCtx& z, uint32_t codec, const uint8_t* in, size_t n,
                   std::vector<uint8_t>& out) {
  switch (codec) {
    case kCompressSnappy:
      snappy_compress_block(in, n, out, z.snap);
      return 0;
    case kCompressGzip:
      return gzip_compress(z, in, n, out);
    case kCompressZlib1:
      return zlib1_compress(z, in, n, out);
  }
  return -3;
}

// big-endian u32 (the PRPC header's byte order)
void put_be32(uint8_t* out, uint32_t v) {
  out[0] = static_cast<uint8_t>(v >> 24);
  out[1] = static_cast<uint8_t>(v >> 16);
  out[2] = static_cast<uint8_t>(v >> 8);
  out[3] = static_cast<uint8_t>(v);
}

uint32_t get_be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

// Peek the 12-byte PRPC header off `in` without consuming — the tb_tbus_peek
// analog shared by the server cut loop and both client read paths.
// 0 = sizes filled and sane (magic, meta <= body <= max_body);
// 1 = fewer than 12 bytes buffered; -1 = not a PRPC frame / oversized.
// fabricscan: sanitizes(body_len, meta_len)
int prpc_peek(const tb_iobuf* in, uint32_t* body_len, uint32_t* meta_len,
              size_t max_body) {
  if (tb_iobuf_size(in) < kPrpcHeader) return 1;
  uint8_t hdr[kPrpcHeader];
  tb_iobuf_copy_to(in, hdr, kPrpcHeader, 0);
  uint32_t b = get_be32(hdr + 4), m = get_be32(hdr + 8);
  if (memcmp(hdr, "PRPC", 4) != 0 || m > b || b > max_body) return -1;
  *body_len = b;
  *meta_len = m;
  return 0;
}

// client-side frame size cap (the tbus client paths use the same bound)
constexpr size_t kClientMaxBody = 512u << 20;

// Append "PRPC" header + response RpcMeta, byte-identical to
// protocol/baidu_std.py pack_response: the response submessage is ALWAYS
// emitted (even empty), zero scalar fields are skipped — including
// compress_type (field 3), stamped when the response payload was
// recompressed.  The caller appends payload (+attachment) after.
void append_prpc_resp_header(tb_iobuf* out, uint64_t cid, uint32_t error_code,
                             const char* error_text, size_t text_len,
                             size_t payload_len, size_t att_len,
                             uint32_t compress) {
  uint8_t meta[512];
  // RpcResponseMeta submessage
  uint8_t sub[400];
  size_t sn = 0;
  if (error_code != 0) {
    sub[sn++] = 0x08;  // field 1, varint
    sn += put_varint(sub + sn, error_code);
  }
  if (text_len > sizeof sub - sn - 12) text_len = sizeof sub - sn - 12;
  if (text_len > 0) {
    sub[sn++] = 0x12;  // field 2, len-delimited
    sn += put_varint(sub + sn, text_len);
    memcpy(sub + sn, error_text, text_len);
    sn += text_len;
  }
  size_t mn = 0;
  meta[mn++] = 0x12;  // RpcMeta.response (field 2)
  mn += put_varint(meta + mn, sn);
  memcpy(meta + mn, sub, sn);
  mn += sn;
  if (compress != 0) {
    meta[mn++] = 0x18;  // compress_type (field 3)
    mn += put_varint(meta + mn, compress);
  }
  if (cid != 0) {
    meta[mn++] = 0x20;  // correlation_id (field 4)
    mn += put_varint(meta + mn, cid);
  }
  if (att_len != 0) {
    meta[mn++] = 0x28;  // attachment_size (field 5)
    mn += put_varint(meta + mn, att_len);
  }
  uint8_t hdr[kPrpcHeader];
  hdr[0] = 'P';
  hdr[1] = 'R';
  hdr[2] = 'P';
  hdr[3] = 'C';
  put_be32(hdr + 4, static_cast<uint32_t>(mn + payload_len + att_len));
  put_be32(hdr + 8, static_cast<uint32_t>(mn));
  // header + meta contiguously (one small append)
  uint8_t scratch[sizeof hdr + sizeof meta];
  memcpy(scratch, hdr, sizeof hdr);
  memcpy(scratch + sizeof hdr, meta, mn);
  tb_iobuf_append(out, scratch, sizeof hdr + mn);
}

// Full client-side PRPC request: `sub` is the pre-encoded RpcRequestMeta
// submessage; the wrapper adds compress_type + correlation_id +
// attachment_size + authentication_data in the field order
// protocol/baidu_std.py emits (1, 3, 4, 5, 7), then payload + attachment.
// The payload is compressed by the CALLER (the Python seam shares one
// codec with the server, so the bytes match the wire's compress_type).
void pack_prpc_request(tb_iobuf* out, const void* sub, size_t sub_len,
                       const void* payload, size_t payload_len,
                       const void* att, size_t att_len, uint64_t cid,
                       uint32_t compress, const void* auth,
                       size_t auth_len) {
  std::vector<uint8_t> meta;
  meta.reserve(sub_len + auth_len + 32);
  uint8_t tmp[10];
  meta.push_back(0x0A);  // RpcMeta.request (field 1)
  meta.insert(meta.end(), tmp, tmp + put_varint(tmp, sub_len));
  const uint8_t* sp = static_cast<const uint8_t*>(sub);
  meta.insert(meta.end(), sp, sp + sub_len);
  if (compress != 0) {
    meta.push_back(0x18);  // compress_type (field 3)
    meta.insert(meta.end(), tmp, tmp + put_varint(tmp, compress));
  }
  if (cid != 0) {
    meta.push_back(0x20);
    meta.insert(meta.end(), tmp, tmp + put_varint(tmp, cid));
  }
  if (att_len != 0) {
    meta.push_back(0x28);
    meta.insert(meta.end(), tmp, tmp + put_varint(tmp, att_len));
  }
  if (auth_len != 0) {
    meta.push_back(0x3A);  // authentication_data (field 7)
    meta.insert(meta.end(), tmp, tmp + put_varint(tmp, auth_len));
    const uint8_t* ap = static_cast<const uint8_t*>(auth);
    meta.insert(meta.end(), ap, ap + auth_len);
  }
  uint8_t hdr[kPrpcHeader];
  hdr[0] = 'P';
  hdr[1] = 'R';
  hdr[2] = 'P';
  hdr[3] = 'C';
  put_be32(hdr + 4,
           static_cast<uint32_t>(meta.size() + payload_len + att_len));
  put_be32(hdr + 8, static_cast<uint32_t>(meta.size()));
  tb_iobuf_append(out, hdr, sizeof hdr);
  tb_iobuf_append(out, meta.data(), meta.size());
  if (payload_len) tb_iobuf_append(out, payload, payload_len);
  if (att_len) tb_iobuf_append(out, att, att_len);
}

// ---------------------------------------------------------------------------
// frame pack helpers
// ---------------------------------------------------------------------------

// append the 32-byte header (+ small meta) contiguously
void append_header(tb_iobuf* out, const void* meta, size_t meta_len,
                   size_t body_rest_len, uint32_t crc, uint32_t cid_lo,
                   uint32_t cid_hi, uint32_t flags, uint32_t error_code) {
  uint32_t h[8];
  h[0] = kMagic;
  h[1] = static_cast<uint32_t>(meta_len + body_rest_len);
  h[2] = flags;
  h[3] = cid_lo;
  h[4] = cid_hi;
  h[5] = static_cast<uint32_t>(meta_len);
  h[6] = crc;
  h[7] = error_code;
  if (meta_len > 0 && meta_len <= 4096) {
    char scratch[4096 + sizeof h];
    memcpy(scratch, h, sizeof h);
    memcpy(scratch + sizeof h, meta, meta_len);
    tb_iobuf_append(out, scratch, sizeof h + meta_len);
  } else {
    tb_iobuf_append(out, h, sizeof h);
    if (meta_len) tb_iobuf_append(out, meta, meta_len);
  }
}

// whole frame from contiguous caller memory
void pack_flat(tb_iobuf* out, const void* meta, size_t meta_len,
               const void* payload, size_t payload_len, const void* att,
               size_t att_len, uint32_t cid_lo, uint32_t cid_hi,
               uint32_t flags, uint32_t error_code) {
  if (meta_len) flags |= kFlagHasMeta;
  uint32_t crc = tb_crc32c(0, meta, meta_len);
  if (flags & kFlagBodyCrc) {
    crc = tb_crc32c(crc, payload, payload_len);
    crc = tb_crc32c(crc, att, att_len);
  }
  append_header(out, meta, meta_len, payload_len + att_len, crc, cid_lo,
                cid_hi, flags, error_code);
  if (payload_len) tb_iobuf_append(out, payload, payload_len);
  if (att_len) tb_iobuf_append(out, att, att_len);
}

// ---------------------------------------------------------------------------
// connection registry (token = versioned respool id; global resolve mutex +
// per-conn refcount gate the fd against cross-thread teardown)
// ---------------------------------------------------------------------------

struct NetLoop;

struct PollObj {
  int kind;  // 0 conn, 1 listener, 2 wake  // fabricscan: owner(init)
  explicit PollObj(int k) : kind(k) {}
  virtual ~PollObj() = default;
};

struct NetConn : PollObj {
  NetConn() : PollObj(0) {}
  int fd = -1;  // fabricscan: owner(init)
  uint64_t token = 0;  // fabricscan: owner(init)
  NetLoop* loop = nullptr;  // fabricscan: owner(init)
  tb_server* srv = nullptr;  // fabricscan: owner(init)
  tb_iobuf* rbuf = nullptr;  // fabricscan: owner(loop)
  tb_iobuf* wbuf = nullptr;  // fabricscan: owner(shared)
  std::mutex wmu;
  bool want_out = false;  // fabricscan: owner(shared)
  bool sniffed = false;  // fabricscan: owner(loop)
  int proto = 0;  // kProtoTbus / kProtoPrpc once sniffed  // fabricscan: owner(loop)
  // one-entry meta memo: a client pumping one method sends byte-identical
  // meta every frame — remember the resolved native method for those exact
  // bytes and skip the JSON scan + name join + flatmap probe (the
  // preferred-protocol-memory idea applied to routing).  On PRPC conns the
  // memo key is the RpcRequestMeta SUBMESSAGE (the correlation id lives
  // outside it, so the submessage stays byte-identical across a pump).
  std::string memo_meta;  // fabricscan: owner(loop)
  uint64_t memo_idx = 0;  // fabricscan: owner(loop)
  long memo_attachment = -1;  // -1 = no memo  // fabricscan: owner(loop)
  long memo_timeout = 0;      // timeout_ms of the memoized meta bytes  // fabricscan: owner(loop)
  // name-keyed second memo for TRACED PRPC frames: their submessage
  // bytes change every call (span ids), so the byte-keyed memo above
  // can never hit — this one compares the decoded service/method slices
  // instead, keeping a traced flood at two memcmps per frame instead of
  // a per-request flatmap probe + name join (the prpc_traced_pump_ns
  // gate's margin lives here)
  std::string memo_svc;  // fabricscan: owner(loop)
  std::string memo_mth;  // fabricscan: owner(loop)
  long memo_name_idx = -1;  // -1 = no memo  // fabricscan: owner(loop)
  // stamped once per readable burst (deadline shed baseline + idle reap);
  // written by the loop thread, read by tb_server_close_idle callers
  std::atomic<uint64_t> last_active_ms{0};
  // per-connection auth verdict cache (brpc's first-frame auth): set by
  // the loop thread after a native verify, or from a Python thread via
  // tb_conn_set_authenticated when the Python route verified first
  std::atomic<bool> authenticated{false};
  std::atomic<bool> dead{false};
  std::atomic<int> refs{0};
};

std::mutex g_conn_mu;
tb_respool* g_conn_pool = nullptr;  // slots hold NetConn*  // fabricscan: owner(shared)

// fabricscan: role(init)
uint64_t conn_register(NetConn* c) {
  std::lock_guard<std::mutex> g(g_conn_mu);
  if (g_conn_pool == nullptr) g_conn_pool = tb_respool_create(sizeof(void*));
  uint64_t id = 0;
  void* slot = tb_respool_get(g_conn_pool, &id);
  *static_cast<NetConn**>(slot) = c;
  c->token = id;
  return id;
}

NetConn* conn_resolve(uint64_t token) {
  std::lock_guard<std::mutex> g(g_conn_mu);
  if (g_conn_pool == nullptr) return nullptr;
  void* slot = tb_respool_address(g_conn_pool, token);
  if (slot == nullptr) return nullptr;
  NetConn* c = *static_cast<NetConn**>(slot);
  if (c == nullptr || c->dead.load(std::memory_order_acquire)) return nullptr;
  c->refs.fetch_add(1, std::memory_order_acq_rel);
  return c;
}

void conn_unref(NetConn* c) { c->refs.fetch_sub(1, std::memory_order_acq_rel); }

// retire the token and wait out foreign holders; afterwards the caller owns
// the conn exclusively (the deferred-close discipline of sock.py _io_refs)
void conn_retire(NetConn* c) {
  {
    std::lock_guard<std::mutex> g(g_conn_mu);
    c->dead.store(true, std::memory_order_release);
    tb_respool_return(g_conn_pool, c->token);
  }
  while (c->refs.load(std::memory_order_acquire) > 0) usleep(50);
}

// ---------------------------------------------------------------------------
// server structures
// ---------------------------------------------------------------------------

struct Wake : PollObj {
  Wake() : PollObj(2) {}
  int fd = -1;  // fabricscan: owner(init)
};

struct Listener : PollObj {
  Listener() : PollObj(1) {}
  int fd = -1;  // fabricscan: owner(loop)
};

struct TelemetryRing;
struct WorkDeque;

struct NetLoop {
  int id = 0;  // reactor index (telemetry records carry it)  // fabricscan: owner(init)
  int epfd = -1;  // fabricscan: owner(init)
  Wake wake;
  // per-reactor listener: every reactor binds the same port with
  // SO_REUSEPORT (multi-reactor servers) so accepts run in parallel and
  // lame-duck teardown happens on each owning loop thread; fd -1 when
  // the reactor has no listener (single-reactor, or REUSEPORT fallback)
  Listener listener;
  std::thread th;
  std::atomic<bool> stopping{false};
  std::vector<NetConn*> conns;  // fabricscan: owner(shared)
  std::mutex conns_mu;  // guards conns (loop thread + stop-time sweep)
  // per-reactor data pools: the burst response batch and per-frame body
  // scratch are owned by the reactor and reused across bursts — nothing
  // on the cut/pack path allocates per burst or crosses a lock
  tb_iobuf* batch = nullptr;  // fabricscan: owner(loop)
  tb_iobuf* scratch = nullptr;  // fabricscan: owner(loop)
  // per-reactor codec context: reusable z_streams, snappy table, and the
  // decompress/recompress scratch vectors (zero cross-reactor sharing)
  ZCtx* zctx = nullptr;  // fabricscan: owner(init)
  // per-reactor counters (tb_server_reactor_stats / stats roll-up)
  std::atomic<uint64_t> live_conns{0};
  std::atomic<uint64_t> native_reqs{0};
  // per-reactor completion ring: loop-thread (and pool-worker) producers
  // never contend with another reactor's — set once before listen
  std::atomic<TelemetryRing*> telemetry{nullptr};
  // per-reactor work-stealing deque (dispatch pool enabled only)
  WorkDeque* deque = nullptr;  // fabricscan: owner(init)
  // loop-thread-only: inline user-callback dispatches in the current
  // readable burst (the queue-depth pressure signal for pool deferral)
  int inline_burst = 0;  // fabricscan: owner(loop)
};

struct NativeMethod {
  int kind;  // fabricscan: owner(init)
  uint32_t index = 0;  // position in tb_server::native_methods (telemetry key)  // fabricscan: owner(init)
  // runtime-retunable (tb_server_set_native_max_concurrency stores from
  // the application thread while loop threads load per request)
  std::atomic<uint32_t> max_concurrency{0};
  std::atomic<uint32_t> nprocessing{0};
  std::atomic<uint64_t> nreq{0};
  std::atomic<uint64_t> nerr{0};
  // long-running: with a dispatch pool enabled, requests to this method
  // always defer to the pool (tb_server_set_native_long_running)
  std::atomic<uint32_t> long_running{0};
  std::string full_name;  // fabricscan: owner(init)
  tb_native_fn fn = nullptr;  // kKindCallback  // fabricscan: owner(init)
  void* ud = nullptr;  // fabricscan: owner(init)
};

struct ErrorCodes {
  // mirrors utils/status.py ErrorCode (the cross-plane error constants)
  uint32_t enomethod = 1002;
  uint32_t elimit = 2004;
  uint32_t erequest = 1003;
  uint32_t edeadline = 4004;
  uint32_t erpcauth = 1004;
};

// the EDEADLINE response text — MUST match utils/status.py berror(
// EDEADLINE) byte-for-byte: the acceptance contract is that a shed
// answered natively is indistinguishable from one answered by the
// Python route
constexpr const char kDeadlineShedText[] = "Deadline expired before dispatch";

// same contract for the native auth rejection: berror(ERPCAUTH)
constexpr const char kUnauthorizedText[] = "Unauthorized";

// ---------------------------------------------------------------------------
// telemetry ring: bounded lock-free queue of completion records (Vyukov's
// bounded MPMC shape — per-cell sequence numbers; producers are the loop
// threads, the consumer is the Python drain).  A full ring DROPS the
// record and counts it: the hot path pays one CAS and a few stores, never
// a wait.  This is the seam that keeps natively-dispatched requests
// observable (per-method latency, sampled rpcz spans, limiter feedback)
// without putting the interpreter back on the fast path — the reference
// feeds bvar/rpcz from inside every protocol's ProcessRequest the same
// way (span.cpp, baidu_rpc_protocol.cpp:307-503).
// ---------------------------------------------------------------------------

// Hot-path timestamp: rdtsc where available (~9 ns vs ~22 ns for the
// vDSO clock — two reads per request make the difference measurable on a
// ~1 µs pump).  Records carry raw ticks; the drain converts them to
// CLOCK_MONOTONIC ns with a calibration refined on every drain, so the
// conversion cost lives entirely on the observer's side.
inline uint64_t telemetry_ticks() {
#if defined(__x86_64__)
  return __rdtsc();
#else
  return tb_monotonic_ns();
#endif
}

// The record ABI is checked THREE ways (header struct, ctypes mirror,
// numpy drain dtype) by fabriclint; this sizeof anchor is the fourth,
// diffed against native_plane.py's _TELEMETRY_RECORD_BYTES by
// fabricscan's plane-parity pass so a grown record cannot ship with a
// stale drain overlay.
static_assert(sizeof(tb_telemetry_record) == 64,
              "tb_telemetry_record ABI is 64 bytes (header/ctypes/numpy "
              "move in lockstep)");

// sampled-word bit layout (mirrored in native_plane._consume_records):
// bit 0 = rpcz sample election, bits 1-2 = request codec id, bit 3 =
// the sampled bit arrived ON THE WIRE (head-based coherent sampling)
constexpr uint32_t kTeleSampleBit = 1u;
constexpr uint32_t kTeleCodecShift = 1;
constexpr uint32_t kTeleWireForced = 8u;

struct TelemetryCell {
  std::atomic<uint64_t> seq{0};
  tb_telemetry_record rec;  // fabricscan: owner(shared)
};

struct TelemetryRing {
  TelemetryCell* cells = nullptr;  // fabricscan: owner(init)
  size_t mask = 0;  // fabricscan: owner(init)
  uint32_t sample_every = 0;  // every Nth record carries sampled=1; 0 = never  // fabricscan: owner(init)
  // tick->ns calibration anchor (taken at creation, ratio refined per
  // drain); on non-x86 ticks ARE ns and the identity ratio holds
  uint64_t cal_ticks0 = 0;  // fabricscan: owner(init)
  uint64_t cal_mono0 = 0;  // fabricscan: owner(init)
  std::atomic<double> ns_per_tick{1.0};
  alignas(64) std::atomic<uint64_t> enqueue_pos{0};
  alignas(64) std::atomic<uint64_t> dequeue_pos{0};
  alignas(64) std::atomic<uint64_t> dropped{0};
  ~TelemetryRing() { delete[] cells; }
};

void telemetry_push(TelemetryRing* r, tb_telemetry_record& rec) {
  TelemetryCell* cell;
  uint64_t pos = r->enqueue_pos.load(std::memory_order_relaxed);
  for (;;) {
    cell = &r->cells[pos & r->mask];
    uint64_t seq = cell->seq.load(std::memory_order_acquire);
    int64_t dif = static_cast<int64_t>(seq) - static_cast<int64_t>(pos);
    if (dif == 0) {
      if (r->enqueue_pos.compare_exchange_weak(pos, pos + 1,
                                               std::memory_order_relaxed))
        break;
    } else if (dif < 0) {
      // consumer hasn't freed this slot yet: the ring is full — drop, the
      // overflow counter is the observer's signal to drain faster
      r->dropped.fetch_add(1, std::memory_order_relaxed);
      return;
    } else {
      pos = r->enqueue_pos.load(std::memory_order_relaxed);
    }
  }
  // the claimed position doubles as the sample counter (exact 1/N
  // without a second atomic on the hot path; drops never claim one).
  // Bit 0 only: the producer's codec/forced bits (>> 1) ride through
  // untouched.  A wire-forced record (bit 3: the head-based sampled bit
  // arrived on the wire) OVERRIDES the local election — the edge's
  // decision propagates like the deadline, so a trace sampled there
  // yields spans at every hop instead of an incoherent scatter.
  rec.sampled =
      (rec.sampled & ~kTeleSampleBit) |
      ((rec.sampled & kTeleWireForced) != 0 ||
               (r->sample_every != 0 && pos % r->sample_every == 0)
           ? kTeleSampleBit
           : 0u);
  cell->rec = rec;
  cell->seq.store(pos + 1, std::memory_order_release);
}

long telemetry_pop(TelemetryRing* r, tb_telemetry_record* out, size_t max) {
  size_t n = 0;
  while (n < max) {
    uint64_t pos = r->dequeue_pos.load(std::memory_order_relaxed);
    TelemetryCell* cell = &r->cells[pos & r->mask];
    uint64_t seq = cell->seq.load(std::memory_order_acquire);
    int64_t dif = static_cast<int64_t>(seq) - static_cast<int64_t>(pos + 1);
    if (dif < 0) break;  // empty (or a producer mid-publish: next drain)
    if (dif > 0) continue;  // another drain raced us past this slot
    if (!r->dequeue_pos.compare_exchange_weak(pos, pos + 1,
                                              std::memory_order_relaxed))
      continue;
    out[n++] = cell->rec;
    cell->seq.store(pos + r->mask + 1, std::memory_order_release);
  }
  return static_cast<long>(n);
}

// per-request routing context shared by the tbus and PRPC dispatch loops
struct ReqCtx {
  int wire;            // kProtoTbus / kProtoPrpc
  uint32_t cid_lo;
  uint32_t cid_hi;
  uint32_t resp_flags; // tbus: response flags to echo (body-crc bit)
  long attachment;     // request attachment size (PRPC echo re-stamps it)
  long timeout_ms;     // propagated deadline budget (0 = none rides this)
  uint32_t compress;   // request compress_type (0 = plain; PRPC only)
  // wire-propagated trace context: the ids land in the telemetry record
  // (the drain parents this hop's span into the caller's trace), the
  // sampled bit forces the record's rpcz election (coherent sampling)
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  uint32_t traced_sampled = 0;
};

// ---------------------------------------------------------------------------
// work-stealing deque (Chase–Lev) + dispatch pool: the reactor loop thread
// is the single owner (push at the bottom; pop only during stop-time
// drain), pool workers steal the top.  A full deque rejects the push and
// the caller runs the work inline — backpressure, never blocking the
// reactor.  This is the bthread M:N shape specialized to "slow native
// user methods must not stall their reactor's cut/pack work" (reference
// task_group.cc steal loops, SURVEY L3).
// ---------------------------------------------------------------------------

struct WorkDeque {
  explicit WorkDeque(size_t cap) {
    size_t c = 64;
    while (c < cap && c < (1u << 20)) c <<= 1;
    cells = new std::atomic<uint64_t>[c];
    mask = c - 1;
  }
  ~WorkDeque() { delete[] cells; }
  alignas(64) std::atomic<int64_t> top{0};     // thieves CAS this
  alignas(64) std::atomic<int64_t> bottom{0};  // owner only
  std::atomic<uint64_t>* cells = nullptr;
  size_t mask = 0;  // fabricscan: owner(init)

  bool push(uint64_t v) {  // owner only
    int64_t b = bottom.load(std::memory_order_relaxed);
    int64_t t = top.load(std::memory_order_acquire);
    if (b - t > static_cast<int64_t>(mask)) return false;  // full
    cells[b & static_cast<int64_t>(mask)].store(v, std::memory_order_relaxed);
    // release: a thief acquiring `bottom` sees the cell store
    bottom.store(b + 1, std::memory_order_release);
    return true;
  }

  bool pop(uint64_t* out) {  // owner only (stop-time drain)
    int64_t b = bottom.load(std::memory_order_relaxed) - 1;
    bottom.store(b, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    int64_t t = top.load(std::memory_order_relaxed);
    if (t > b) {  // empty
      bottom.store(b + 1, std::memory_order_relaxed);
      return false;
    }
    uint64_t v = cells[b & static_cast<int64_t>(mask)].load(
        std::memory_order_relaxed);
    if (t == b) {
      // last element: race the thieves for it via top
      if (!top.compare_exchange_strong(t, t + 1, std::memory_order_seq_cst,
                                       std::memory_order_relaxed)) {
        bottom.store(b + 1, std::memory_order_relaxed);
        return false;  // a thief won
      }
      bottom.store(b + 1, std::memory_order_relaxed);
    }
    *out = v;
    return true;
  }

  bool steal(uint64_t* out) {  // any thief
    int64_t t = top.load(std::memory_order_acquire);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    int64_t b = bottom.load(std::memory_order_acquire);
    if (t >= b) return false;  // empty
    // safe stale read: push() refuses to reuse a cell until top has
    // advanced past it, so a concurrent overwrite implies our CAS fails
    uint64_t v = cells[t & static_cast<int64_t>(mask)].load(
        std::memory_order_relaxed);
    if (!top.compare_exchange_strong(t, t + 1, std::memory_order_seq_cst,
                                     std::memory_order_relaxed))
      return false;  // lost the race (owner pop or another thief)
    *out = v;
    return true;
  }

  long size() const {
    int64_t b = bottom.load(std::memory_order_relaxed);
    int64_t t = top.load(std::memory_order_relaxed);
    return b > t ? static_cast<long>(b - t) : 0;
  }
};

// one deferred native dispatch: everything the worker needs to run the
// method, pack the response in the right wire protocol, and append the
// completion record into the OWNING reactor's telemetry ring
struct WorkTask {
  NativeMethod* nm = nullptr;  // fabricscan: owner(worker)
  tb_server* srv = nullptr;  // fabricscan: owner(worker)
  NetLoop* loop = nullptr;  // owning reactor (ring + reactor_id)  // fabricscan: owner(worker)
  uint64_t conn_token = 0;  // fabricscan: owner(worker)
  ReqCtx rc{};  // fabricscan: owner(worker)
  uint32_t limited = 0;    // nprocessing held across queue + run  // fabricscan: owner(worker)
  uint64_t t_start = 0;    // telemetry ticks at dispatch entry (0 = off)  // fabricscan: owner(worker)
  uint64_t arrival_ms = 0; // frame's burst-arrival stamp (deadline base)  // fabricscan: owner(worker)
  size_t req_len = 0;  // fabricscan: owner(worker)
  char* req = nullptr;     // contiguous request copy (worker frees)  // fabricscan: owner(worker)
};

struct DispatchPool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<uint64_t> pending{0};
  std::atomic<bool> stopping{false};
};

}  // namespace

struct tb_server {
  std::vector<NetLoop*> loops;  // fabricscan: owner(init)
  int port = 0;  // fabricscan: owner(init)
  std::atomic<size_t> next_loop{0};
  tb_frame_fn frame_cb = nullptr;  // fabricscan: owner(init)
  void* frame_ctx = nullptr;  // fabricscan: owner(init)
  tb_handoff_fn handoff_cb = nullptr;  // fabricscan: owner(init)
  void* handoff_ctx = nullptr;  // fabricscan: owner(init)
  tb_closed_fn closed_cb = nullptr;  // fabricscan: owner(init)
  void* closed_ctx = nullptr;  // fabricscan: owner(init)
  size_t max_body = 512u << 20;  // fabricscan: owner(init)
  ErrorCodes errs;  // fabricscan: owner(init)
  tb_flatmap* methods = nullptr;  // key -> index into native_methods  // fabricscan: owner(init)
  std::vector<NativeMethod*> native_methods;  // fabricscan: owner(init)
  std::atomic<uint64_t> accepted{0};
  std::atomic<uint64_t> cb_frames{0};
  std::atomic<uint64_t> handoffs{0};
  // requests answered EDEADLINE because their propagated budget expired
  // before dispatch (the deadline_shed_count feed for native ports)
  std::atomic<uint64_t> deadline_sheds{0};
  // ---- production-shaped traffic knobs (pre-listen configuration) ----
  // response compression floor: decompressed payloads below it answer
  // uncompressed (native_compress_min_bytes; the Python route applies
  // the same floor so the planes stay byte-identical)
  size_t compress_min = 0;  // fabricscan: owner(init)
  // decompressed-size ceiling (max_decompress_bytes): a tiny bomb must
  // not expand unbounded into server memory on either plane
  size_t max_decompress = 256u << 20;  // fabricscan: owner(init)
  // auth seam: a verifier callback (tb_server_set_auth — the arbitrary-
  // Authenticator deferral, one interpreter crossing per CONNECTION) or
  // a constant-time token table (tb_server_set_auth_tokens — the
  // steady-state path never enters the interpreter).  Verified once per
  // connection, verdict cached on the conn (brpc's first-frame auth).
  tb_auth_fn auth_fn = nullptr;  // fabricscan: owner(init)
  void* auth_ud = nullptr;  // fabricscan: owner(init)
  std::vector<std::string> auth_tokens;  // fabricscan: owner(init)
  std::atomic<bool> auth_enabled{false};
  std::atomic<uint64_t> auth_rejects{0};
  // compressed-traffic byte counters (native_compress_bytes_saved feed):
  // request wire/raw and response raw/wire
  std::atomic<uint64_t> c_in_wire{0};
  std::atomic<uint64_t> c_in_raw{0};
  std::atomic<uint64_t> c_out_raw{0};
  std::atomic<uint64_t> c_out_wire{0};
  // lame-duck: stop accepting while existing connections drain; EVERY
  // reactor tears down its own listener on its own loop thread at its
  // next wakeup (per-reactor listeners via SO_REUSEPORT)
  std::atomic<bool> accept_paused{false};
  std::atomic<bool> stopped{false};
  bool listening = false;       // pre-listen-only knobs gate on this  // fabricscan: owner(init)
  bool telemetry_enabled = false;  // per-reactor rings live in the loops  // fabricscan: owner(init)
  // work-stealing dispatch pool (tb_server_set_dispatch_pool): null =
  // every native method runs inline on its reactor
  DispatchPool* pool = nullptr;  // fabricscan: owner(init)
  int pool_workers = 0;  // fabricscan: owner(init)
};

namespace {

uint64_t method_key(const char* name, size_t n) {
  uint64_t lo = tb_crc32c(0, name, n);
  uint64_t hi =
      crc32(0, reinterpret_cast<const Bytef*>(name), static_cast<uInt>(n));
  return lo | (hi << 32);
}

// constant-time credential compare: the loop always walks every token
// byte, and a length mismatch folds into the same accumulator instead of
// short-circuiting — a timing probe learns nothing about how much of a
// token it matched
int ct_token_match(const std::string& tok, const char* a, size_t alen) {
  unsigned diff = static_cast<unsigned>(tok.size() ^ alen);
  for (size_t i = 0; i < tok.size(); ++i) {
    uint8_t b = i < alen ? static_cast<uint8_t>(a[i]) : 0;
    diff |= static_cast<uint8_t>(tok[i]) ^ b;
  }
  return diff == 0 ? 1 : 0;
}

// verify a connection's first-frame credential.  Token table first (pure
// C, constant-time, no interpreter); else the registered verifier (for a
// Python Authenticator this is ONE GIL crossing per connection — the
// verdict caches on the conn).  Auth enabled with neither = fail closed.
bool verify_auth(tb_server* s, NetConn* c, const char* data, size_t len) {
  if (!s->auth_tokens.empty()) {
    int ok = 0;
    for (const std::string& t : s->auth_tokens)
      ok |= ct_token_match(t, data, len);
    return ok != 0;
  }
  if (s->auth_fn != nullptr) {
    char ip[64] = {0};
    int port = 0;
    sockaddr_in addr{};
    socklen_t alen = sizeof addr;
    if (getpeername(c->fd, reinterpret_cast<sockaddr*>(&addr), &alen) == 0 &&
        addr.sin_family == AF_INET) {
      inet_ntop(AF_INET, &addr.sin_addr, ip, sizeof ip);
      port = ntohs(addr.sin_port);
    }
    return s->auth_fn(s->auth_ud, data, len, ip, port) == 0;
  }
  return false;
}

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void set_nodelay(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
}

// ---- write path (per-conn mutex; any thread) ----

// under c->wmu: drain wbuf to the fd, arming/disarming EPOLLOUT
// fabricscan: locked
void conn_flush_locked(NetConn* c) {
  while (tb_iobuf_size(c->wbuf) > 0) {
    long rc = tb_iobuf_cut_into_fd(c->wbuf, c->fd, 4u << 20);
    if (rc > 0) continue;
    if (rc == -EINTR) continue;
    if (rc == 0 || rc == -EAGAIN || rc == -EWOULDBLOCK) {
      if (!c->want_out) {
        c->want_out = true;
        epoll_event ev{};
        ev.events = EPOLLIN | EPOLLOUT;
        ev.data.ptr = static_cast<PollObj*>(c);
        epoll_ctl(c->loop->epfd, EPOLL_CTL_MOD, c->fd, &ev);
      }
      return;
    }
    // hard error: shutdown so the loop thread reaps via EPOLLHUP
    shutdown(c->fd, SHUT_RDWR);
    return;
  }
  if (c->want_out) {
    c->want_out = false;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = static_cast<PollObj*>(c);
    epoll_ctl(c->loop->epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
}

void conn_queue_iobuf(NetConn* c, const tb_iobuf* data) {
  std::lock_guard<std::mutex> g(c->wmu);
  tb_iobuf_append_iobuf(c->wbuf, data);
  conn_flush_locked(c);
}

// loop-thread-only teardown; fd closes only after foreign refs drain
void conn_destroy(NetConn* c, bool close_fd) {
  epoll_ctl(c->loop->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  uint64_t token = c->token;
  conn_retire(c);
  if (close_fd && c->fd >= 0) close(c->fd);
  if (c->loop) c->loop->live_conns.fetch_sub(1);
  // close_fd==false means handoff: the connection lives on in Python
  if (close_fd && c->srv && c->srv->closed_cb != nullptr)
    c->srv->closed_cb(c->srv->closed_ctx, token);
  {
    std::lock_guard<std::mutex> g(c->loop->conns_mu);
    auto& v = c->loop->conns;
    for (size_t i = 0; i < v.size(); ++i)
      if (v[i] == c) {
        v[i] = v.back();
        v.pop_back();
        break;
      }
  }
  tb_iobuf_destroy(c->rbuf);
  tb_iobuf_destroy(c->wbuf);
  delete c;
}

// ---- server-side frame dispatch ----

// append an error response frame into `out` (flushed with the batch)
void append_error(tb_iobuf* out, const ReqCtx& rc, uint32_t code,
                  const char* text) {
  if (rc.wire == kProtoPrpc) {
    append_prpc_resp_header(
        out, static_cast<uint64_t>(rc.cid_lo) |
                 (static_cast<uint64_t>(rc.cid_hi) << 32),
        code, text, strlen(text), 0, 0, 0);
    return;
  }
  char meta[256];
  int n = snprintf(meta, sizeof meta, "{\"error_text\":\"%s\"}", text);
  if (n < 0) n = 0;
  pack_flat(out, meta, static_cast<size_t>(n), nullptr, 0, nullptr, 0,
            rc.cid_lo, rc.cid_hi, kFlagResponse, code);
}

// ONE completion-record fill for every dispatch path (inline, pool run,
// pool shed): the 64-byte ABI has a single writer, so a layout change
// cannot silently diverge between the inline and deferred planes.
void push_completion_record(TelemetryRing* tr, NativeMethod* nm,
                            uint32_t err, uint64_t t_start, uint64_t cid64,
                            size_t req_len, size_t resp_len,
                            int reactor_id, const ReqCtx& rc) {
  if (tr == nullptr) return;
  const uint32_t codec = rc.compress;
  tb_telemetry_record rec;
  rec.method_idx = nm->index;
  rec.error_code = err;
  rec.start_ns = t_start;  // raw ticks; the drain converts to ns
  rec.latency_ns = telemetry_ticks() - t_start;
  rec.correlation_id = cid64;
  rec.request_size = static_cast<uint32_t>(
      req_len > 0xFFFFFFFFu ? 0xFFFFFFFFu : req_len);
  rec.response_size = static_cast<uint32_t>(
      resp_len > 0xFFFFFFFFu ? 0xFFFFFFFFu : resp_len);
  // bits 1-2 carry the request's codec id (0 = uncompressed); bit 0 is
  // the sample election telemetry_push stamps from the claimed position
  // (bit 3 — the wire-propagated sampled bit — forces it there).
  // Out-of-enum wire values (rejected EREQUEST upstream) record as 0 —
  // a plain mask would alias compress_type=9 onto "snappy" in /rpcz.
  rec.sampled = ((codec <= 3u ? codec : 0u) << kTeleCodecShift) |
                (rc.traced_sampled != 0 ? kTeleWireForced : 0u);
  rec.reactor_id = static_cast<uint32_t>(reactor_id);
  // wire trace context: the drain parents this hop's server span into
  // the CALLER's trace (fresh ids are minted only when these are 0)
  rec.trace_id = rc.trace_id;
  rec.span_id = rc.span_id;
  telemetry_push(tr, rec);
}

// Pack a user-callback result (or its error) into `out` in the
// request's wire protocol — shared by the inline dispatch and the pool
// worker, so the two planes answer byte-identically by construction.
// `z`/`srv` drive response recompression: a PRPC request that arrived
// compressed gets its response compressed with the same codec when the
// payload clears the floor (the Python _send_response discipline).
// fabricscan: borrows(ZCtx)
void pack_callback_result(tb_iobuf* out, NativeMethod* nm, const ReqCtx& rc,
                          uint64_t cid64, int rc2, const char* resp,
                          size_t resp_len, uint32_t* t_err, size_t* t_resp,
                          tb_server* srv, ZCtx* z) {
  if (rc2 != 0) {
    nm->nerr.fetch_add(1, std::memory_order_relaxed);
    append_error(out, rc, static_cast<uint32_t>(rc2),
                 "native method failed");
    *t_err = static_cast<uint32_t>(rc2);
  } else if (rc.wire == kProtoPrpc) {
    if (rc.compress != 0 && resp_len > 0 && resp_len >= srv->compress_min &&
        codec_compress(*z, rc.compress,
                       reinterpret_cast<const uint8_t*>(resp), resp_len,
                       z->cbuf) == 0) {
      srv->c_out_raw.fetch_add(resp_len, std::memory_order_relaxed);
      srv->c_out_wire.fetch_add(z->cbuf.size(), std::memory_order_relaxed);
      append_prpc_resp_header(out, cid64, 0, nullptr, 0, z->cbuf.size(), 0,
                              rc.compress);
      if (!z->cbuf.empty())
        tb_iobuf_append(out, z->cbuf.data(), z->cbuf.size());
      *t_resp = z->cbuf.size();
    } else {
      append_prpc_resp_header(out, cid64, 0, nullptr, 0, resp_len, 0, 0);
      if (resp_len) tb_iobuf_append(out, resp, resp_len);
      *t_resp = resp_len;
    }
  } else {
    uint32_t flags = kFlagResponse | rc.resp_flags;
    uint32_t crc = tb_crc32c(0, nullptr, 0);
    if (flags & kFlagBodyCrc) crc = tb_crc32c(crc, resp, resp_len);
    append_header(out, nullptr, 0, resp_len, crc, rc.cid_lo, rc.cid_hi,
                  flags, 0);
    if (resp_len) tb_iobuf_append(out, resp, resp_len);
    *t_resp = resp_len;
  }
}

// run one deferred task on a pool worker: user method, response pack in
// the request's wire protocol, completion record into the OWNING
// reactor's ring.  The connection is token-addressed — it may have died
// while the task sat in the deque (the response is then dropped, exactly
// like a death between dispatch and flush).
void run_pool_task(WorkTask* t) {
  NativeMethod* nm = t->nm;
  const uint64_t cid64 = static_cast<uint64_t>(t->rc.cid_lo) |
                         (static_cast<uint64_t>(t->rc.cid_hi) << 32);
  tb_iobuf* out = tb_iobuf_create();
  uint32_t t_err = 0;
  size_t t_resp = 0;
  // the propagated deadline keeps ticking while the task waits in the
  // deque: a budget that expired in the queue is shed EDEADLINE here —
  // running the (slow, that's why it deferred) method for a caller that
  // already gave up would burn worker capacity exactly when overloaded
  if (t->rc.timeout_ms > 0 &&
      now_ms() - t->arrival_ms >= static_cast<uint64_t>(t->rc.timeout_ms)) {
    t->srv->deadline_sheds.fetch_add(1, std::memory_order_relaxed);
    nm->nerr.fetch_add(1, std::memory_order_relaxed);
    append_error(out, t->rc, t->srv->errs.edeadline, kDeadlineShedText);
    t_err = t->srv->errs.edeadline;
  } else {
    char* resp = nullptr;
    size_t resp_len = 0;
    int rc2 = nm->fn(nm->ud, t->req, t->req_len, &resp, &resp_len);
    // worker-local codec context: the reactor's ZCtx belongs to its loop
    // thread, and a deferred (slow) method is off the hot path anyway
    ZCtx z;
    pack_callback_result(out, nm, t->rc, cid64, rc2, resp, resp_len,
                         &t_err, &t_resp, t->srv, &z);
    free(resp);
  }
  NetConn* c = conn_resolve(t->conn_token);
  if (c != nullptr) {
    conn_queue_iobuf(c, out);
    conn_unref(c);
  }
  tb_iobuf_destroy(out);
  if (t->limited) nm->nprocessing.fetch_sub(1);
  if (t->t_start != 0)  // dispatch entry: queue wait is in the latency
    push_completion_record(
        t->loop->telemetry.load(std::memory_order_acquire), nm, t_err,
        t->t_start, cid64, t->req_len, t_resp, t->loop->id, t->rc);
  free(t->req);
  delete t;
}

// fabricscan: role(worker)
void pool_worker(tb_server* s, size_t widx) {
  DispatchPool* p = s->pool;
  const size_t nloops = s->loops.size();
  for (;;) {
    uint64_t v = 0;
    bool got = false;
    // steal from the preferred deque first, then sweep the others — the
    // "steal on empty" half of the Chase–Lev discipline
    for (size_t k = 0; k < nloops && !got; ++k)
      got = s->loops[(widx + k) % nloops]->deque->steal(&v);
    if (got) {
      p->pending.fetch_sub(1, std::memory_order_relaxed);
      run_pool_task(reinterpret_cast<WorkTask*>(v));
      continue;
    }
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->stopping.load(std::memory_order_acquire)) return;
    if (p->pending.load(std::memory_order_acquire) > 0) continue;  // rescan
    p->cv.wait_for(lk, std::chrono::milliseconds(50));
    if (p->stopping.load(std::memory_order_acquire)) return;
  }
}

// budget of inline user-callback dispatches per readable burst: past it,
// further callback-kind frames of the burst defer to the pool even when
// not flagged long-running (queue-depth pressure — a flood of one method
// must not monopolize the reactor's cut/pack slot)
constexpr int kInlineBurstBudget = 32;

// Native method kinds: the response is built and appended into the burst's
// batch without ever leaving C++ — the whole ProcessRpcRequest/user code/
// SendRpcResponse round (baidu_rpc_protocol.cpp:307-503,136) for these
// methods is native.  `out` collects every response of one readable burst;
// the caller queues it once (one writev per burst, not per request).
// `body` stays owned by the caller (the reactor's reusable scratch —
// creating/destroying an iobuf handle per request was measurable on the
// pump's ns/req floor); echo ref-shares its blocks into `out` before the
// caller clears it.
void run_native(NetConn* c, NativeMethod* nm, const ReqCtx& rc,
                tb_iobuf* body, tb_iobuf* out) {
  nm->nreq.fetch_add(1, std::memory_order_relaxed);
  c->loop->native_reqs.fetch_add(1, std::memory_order_relaxed);
  const uint64_t cid64 = static_cast<uint64_t>(rc.cid_lo) |
                         (static_cast<uint64_t>(rc.cid_hi) << 32);
  // telemetry: one record per dispatched request into the reactor's own
  // MPSC ring — the only hot-path cost is clock reads + one CAS
  TelemetryRing* tr = c->loop->telemetry.load(std::memory_order_acquire);
  const uint64_t t_start = tr != nullptr ? telemetry_ticks() : 0;
  const size_t req_len = tr != nullptr ? tb_iobuf_size(body) : 0;
  auto telemetry_done = [&](uint32_t err, size_t resp_len) {
    push_completion_record(tr, nm, err, t_start, cid64, req_len, resp_len,
                           c->loop->id, rc);
  };
  // deadline shed (reference server-side timeout_ms handling): budget
  // expired between the frame's ARRIVAL (burst read stamp) and this
  // dispatch — behind queued frames of the burst or a slow native
  // method — is answered EDEADLINE without running the method.  The
  // response text matches utils/status.py berror(EDEADLINE) so native
  // and Python sheds are byte-identical.
  if (rc.timeout_ms > 0) {
    uint64_t arrived = c->last_active_ms.load(std::memory_order_relaxed);
    if (now_ms() - arrived >= static_cast<uint64_t>(rc.timeout_ms)) {
      c->srv->deadline_sheds.fetch_add(1, std::memory_order_relaxed);
      nm->nerr.fetch_add(1, std::memory_order_relaxed);
      append_error(out, rc, c->srv->errs.edeadline, kDeadlineShedText);
      telemetry_done(c->srv->errs.edeadline, 0);
      return;  // caller owns body
    }
  }
  // snapshot ONCE: a runtime retune between the admission fetch_add and
  // the completion fetch_sub must see a consistent gate, or the counter
  // leaks (limit dropped to 0 mid-request) / underflows (raised from 0)
  const uint32_t limit = nm->max_concurrency.load(std::memory_order_relaxed);
  if (limit && nm->nprocessing.fetch_add(1) >= limit) {
    nm->nprocessing.fetch_sub(1);
    nm->nerr.fetch_add(1, std::memory_order_relaxed);
    append_error(out, rc, c->srv->errs.elimit, "concurrency limit reached");
    telemetry_done(c->srv->errs.elimit, 0);
    return;  // caller owns body
  }
  // native codec round (PRPC): decompress the payload IN PLACE so every
  // downstream consumer — the pool copy, the echo, a user callback —
  // sees raw bytes, exactly like the Python route's pre-handler
  // decompress.  Rejects are answered EREQUEST, with the Python route's
  // deterministic texts (unknown codec, ceiling) byte-for-byte.
  ZCtx& z = *c->loop->zctx;
  if (rc.compress != 0) {
    const size_t wlen = tb_iobuf_size(body);
    const size_t att = static_cast<size_t>(rc.attachment);
    const size_t pay = wlen - att;
    z.ibuf.resize(pay);
    if (pay) tb_iobuf_copy_to(body, z.ibuf.data(), pay, 0);
    int drc = codec_decompress(z, rc.compress, z.ibuf.data(), pay,
                               c->srv->max_decompress, z.dbuf);
    if (drc != 0) {
      char text[160];
      if (drc == -3) {
        snprintf(text, sizeof text,
                 "decompress failed: unknown compression codec 'wire-%u'",
                 rc.compress);
      } else if (drc == -2) {
        snprintf(text, sizeof text,
                 "decompress failed: decompressed size exceeds "
                 "max_decompress_bytes (%zu)",
                 c->srv->max_decompress);
      } else {
        snprintf(text, sizeof text, "decompress failed: corrupt %s body",
                 codec_name(rc.compress));
      }
      nm->nerr.fetch_add(1, std::memory_order_relaxed);
      append_error(out, rc, c->srv->errs.erequest, text);
      if (limit) nm->nprocessing.fetch_sub(1);
      telemetry_done(c->srv->errs.erequest, 0);
      return;  // caller owns body
    }
    c->srv->c_in_wire.fetch_add(pay, std::memory_order_relaxed);
    c->srv->c_in_raw.fetch_add(z.dbuf.size(), std::memory_order_relaxed);
    // rebuild the body: decompressed payload + untouched attachment
    z.abuf.resize(att);
    if (att) tb_iobuf_copy_to(body, z.abuf.data(), att, pay);
    tb_iobuf_clear(body);
    if (!z.dbuf.empty())
      tb_iobuf_append(body, z.dbuf.data(), z.dbuf.size());
    if (att) tb_iobuf_append(body, z.abuf.data(), att);
  }
  // work-stealing deferral: user methods flagged long-running — or
  // arriving behind a queue-depth-pressured burst — hand off to the
  // dispatch pool so one slow handler can't stall this reactor's
  // cut/pack work.  Admission (nprocessing above) spans queue + run; the
  // worker appends the telemetry record at completion.  A full deque
  // falls through and runs inline: backpressure, never blocking.
  DispatchPool* pool = c->srv->pool;
  if (pool != nullptr && nm->kind == kKindCallback &&
      (nm->long_running.load(std::memory_order_relaxed) != 0 ||
       c->loop->inline_burst >= kInlineBurstBudget)) {
    size_t blen = tb_iobuf_size(body);
    char* req = static_cast<char*>(malloc(blen ? blen : 1));
    if (req != nullptr) {
      if (blen) tb_iobuf_copy_to(body, req, blen, 0);
      WorkTask* t = new WorkTask();
      t->nm = nm;
      t->srv = c->srv;
      t->loop = c->loop;
      t->conn_token = c->token;
      t->rc = rc;
      t->limited = limit ? 1u : 0u;
      t->t_start = tr != nullptr ? t_start : 0;
      t->arrival_ms = c->last_active_ms.load(std::memory_order_relaxed);
      t->req_len = blen;
      t->req = req;
      if (c->loop->deque->push(reinterpret_cast<uint64_t>(t))) {
        pool->pending.fetch_add(1, std::memory_order_release);
        {
          // empty critical section pairs with the worker's wait: a
          // sleeper that checked pending before our fetch_add cannot
          // miss the notify (this path is already off the 544 ns lane)
          std::lock_guard<std::mutex> g(pool->mu);
        }
        pool->cv.notify_one();
        return;  // caller owns body; worker answers
      }
      delete t;
      free(req);
    }
  }
  if (nm->kind == kKindCallback) ++c->loop->inline_burst;
  uint32_t flags = kFlagResponse | rc.resp_flags;
  char meta[64];
  size_t meta_len = 0;
  uint32_t t_err = 0;  // what telemetry records for this request
  size_t t_resp = 0;
  if (nm->kind == kKindEcho) {
    size_t blen = tb_iobuf_size(body);
    if (rc.wire == kProtoPrpc && rc.compress != 0) {
      // recompress the echoed payload with the request's codec, floor
      // honored (tiny payloads answer uncompressed — the reference's
      // response_compress_type discipline); the attachment travels
      // uncompressed like the Python route.  dbuf still holds the
      // decompressed payload from the codec round above.
      const size_t att = static_cast<size_t>(rc.attachment);
      const size_t raw_len = blen - att;
      uint32_t out_codec =
          raw_len > 0 && raw_len >= c->srv->compress_min &&
                  codec_compress(z, rc.compress, z.dbuf.data(), raw_len,
                                 z.cbuf) == 0
              ? rc.compress
              : 0;
      if (out_codec != 0) {
        c->srv->c_out_raw.fetch_add(raw_len, std::memory_order_relaxed);
        c->srv->c_out_wire.fetch_add(z.cbuf.size(),
                                     std::memory_order_relaxed);
        append_prpc_resp_header(out, cid64, 0, nullptr, 0, z.cbuf.size(),
                                att, out_codec);
        if (!z.cbuf.empty())
          tb_iobuf_append(out, z.cbuf.data(), z.cbuf.size());
        if (att) tb_iobuf_append(out, z.abuf.data(), att);
        t_resp = z.cbuf.size() + att;
      } else {
        append_prpc_resp_header(out, cid64, 0, nullptr, 0, raw_len, att, 0);
        tb_iobuf_append_iobuf(out, body);  // decompressed payload + att
        t_resp = blen;
      }
      if (limit) nm->nprocessing.fetch_sub(1);
      telemetry_done(0, t_resp);
      return;  // caller owns body
    }
    if (rc.wire == kProtoPrpc) {
      append_prpc_resp_header(out, cid64, 0, nullptr, 0,
                              blen - static_cast<size_t>(rc.attachment),
                              static_cast<size_t>(rc.attachment), 0);
    } else {
      if (rc.attachment > 0) {
        int n = snprintf(meta, sizeof meta, "{\"attachment_size\":%ld}",
                         rc.attachment);
        meta_len = n > 0 ? static_cast<size_t>(n) : 0;
      }
      if (meta_len) flags |= kFlagHasMeta;
      uint32_t crc = tb_crc32c(0, meta, meta_len);
      if (flags & kFlagBodyCrc) crc = tb_iobuf_crc32c(body, crc, 0, blen);
      append_header(out, meta, meta_len, blen, crc, rc.cid_lo, rc.cid_hi,
                    flags, 0);
    }
    tb_iobuf_append_iobuf(out, body);  // zero-copy: request refs shared
    t_resp = blen;
  } else if (nm->kind == kKindCallback) {
    // contiguous request for the C ABI (stack buffer for small bodies)
    size_t blen = tb_iobuf_size(body);
    char stackbuf[4096];
    char* req = blen <= sizeof stackbuf ? stackbuf
                                        : static_cast<char*>(malloc(blen));
    if (req == nullptr) {  // OOM on a huge body: an error response, not a crash
      nm->nerr.fetch_add(1, std::memory_order_relaxed);
      append_error(out, rc, c->srv->errs.erequest,
                   "request too large to stage");
      if (limit) nm->nprocessing.fetch_sub(1);
      telemetry_done(c->srv->errs.erequest, 0);
      return;  // caller owns body
    }
    if (blen) tb_iobuf_copy_to(body, req, blen, 0);
    char* resp = nullptr;
    size_t resp_len = 0;
    int rc2 = nm->fn(nm->ud, req, blen, &resp, &resp_len);
    if (req != stackbuf) free(req);
    pack_callback_result(out, nm, rc, cid64, rc2, resp, resp_len, &t_err,
                         &t_resp, c->srv, &z);
    free(resp);
  } else {  // nop
    if (rc.wire == kProtoPrpc) {
      append_prpc_resp_header(out, cid64, 0, nullptr, 0, 0, 0, 0);
    } else {
      append_header(out, nullptr, 0, 0, tb_crc32c(0, nullptr, 0), rc.cid_lo,
                    rc.cid_hi, flags, 0);
    }
  }
  // body is the caller's reusable scratch: NOT destroyed here (the echo
  // kind ref-shared its blocks into `out`; clear just drops this handle)
  if (limit) nm->nprocessing.fetch_sub(1);
  telemetry_done(t_err, t_resp);
}

enum class FrameStatus { kOk, kHandoff, kKilled };

void do_handoff(NetConn* c) {
  tb_server* s = c->srv;
  s->handoffs.fetch_add(1, std::memory_order_relaxed);
  size_t n = tb_iobuf_size(c->rbuf);
  char* buffered = static_cast<char*>(malloc(n ? n : 1));
  if (n) tb_iobuf_copy_to(c->rbuf, buffered, n, 0);
  int fd = c->fd;
  tb_handoff_fn cb = s->handoff_cb;
  void* ctx = s->handoff_ctx;
  conn_destroy(c, /*close_fd=*/false);
  if (cb != nullptr) {
    cb(ctx, fd, buffered, n);  // callee owns fd from here
  } else {
    close(fd);
  }
  free(buffered);
}

FrameStatus process_frames_tbus(NetConn* c);
FrameStatus process_frames_prpc(NetConn* c);

FrameStatus process_frames(NetConn* c) {
  if (!c->sniffed) {
    if (tb_iobuf_size(c->rbuf) < 4) return FrameStatus::kOk;
    uint32_t magic = 0;
    tb_iobuf_copy_to(c->rbuf, &magic, 4, 0);
    if (magic == kMagic) {
      c->proto = kProtoTbus;
    } else if (magic == kMagicPrpc) {
      // baidu_std spoken natively: no interpreter, no fd handoff (the
      // handoff fallback still owns every OTHER protocol)
      c->proto = kProtoPrpc;
    } else {
      do_handoff(c);
      return FrameStatus::kHandoff;
    }
    c->sniffed = true;
  }
  return c->proto == kProtoPrpc ? process_frames_prpc(c)
                                : process_frames_tbus(c);
}

FrameStatus process_frames_tbus(NetConn* c) {
  tb_server* s = c->srv;
  // One response batch per readable burst: native responses append here
  // and flush with ONE conn_queue_iobuf (one writev) at every exit —
  // the per-request syscall was the dominant cost of the old shape.
  // Both buffers are the REACTOR's data pool (created once per loop,
  // cleared per burst): the hot path allocates nothing and never shares
  // them with another reactor.
  tb_iobuf* batch = c->loop->batch;
  tb_iobuf* scratch = c->loop->scratch;  // per-frame body, cleared and reused
  auto flush = [&](FrameStatus st) {
    // every exit flushes: even a killed connection sends the responses of
    // the frames that parsed cleanly before the bad one
    if (tb_iobuf_size(batch) > 0) conn_queue_iobuf(c, batch);
    tb_iobuf_clear(batch);
    tb_iobuf_clear(scratch);
    return st;
  };
  for (;;) {
    tb_tbus_hdr hdr;
    int rc = tb_tbus_peek(c->rbuf, &hdr);
    if (rc == 1) return flush(FrameStatus::kOk);
    if (rc == -1 || hdr.meta_len > hdr.body_len || hdr.body_len > s->max_body) {
      flush(FrameStatus::kKilled);  // earlier valid responses go out
      conn_destroy(c, true);
      return FrameStatus::kKilled;
    }
    if (tb_iobuf_size(c->rbuf) < kHeader + hdr.body_len)
      return flush(FrameStatus::kOk);
    char mstack[4096];
    std::string mheap;
    char* mptr = nullptr;
    if (hdr.meta_len > 0) {
      if (hdr.meta_len <= sizeof mstack) {
        mptr = mstack;
      } else {
        mheap.resize(hdr.meta_len);
        mptr = &mheap[0];
      }
    }
    rc = tb_tbus_cut(c->rbuf, &hdr, mptr, scratch);
    if (rc != 0) {  // crc mismatch / malformed: the stream can't re-sync
      flush(FrameStatus::kKilled);
      conn_destroy(c, true);
      return FrameStatus::kKilled;
    }
    const char* cb_meta = mptr != nullptr ? mptr : mstack;  // never null
    // native fast path: plain request frame whose meta is fully
    // understood, on a connection whose auth (if the server wants any)
    // already settled — tbus credentials ride the JSON meta's extra
    // object, which the Python route owns, so an unproven connection's
    // frames route there until server_check marks it (the mark flows
    // back via tb_conn_set_authenticated)
    if ((hdr.flags & (kFlagResponse | kFlagStream)) == 0 &&
        (!s->auth_enabled.load(std::memory_order_relaxed) ||
         c->authenticated.load(std::memory_order_relaxed))) {
      if (c->memo_attachment >= 0 && hdr.meta_len == c->memo_meta.size() &&
          memcmp(cb_meta, c->memo_meta.data(), hdr.meta_len) == 0 &&
          c->memo_attachment <= static_cast<long>(tb_iobuf_size(scratch))) {
        ReqCtx rc2{kProtoTbus, hdr.cid_lo, hdr.cid_hi,
                   hdr.flags & kFlagBodyCrc, c->memo_attachment,
                   c->memo_timeout, 0};
        run_native(c, s->native_methods[c->memo_idx], rc2, scratch, batch);
        tb_iobuf_clear(scratch);
        continue;
      }
      MetaLite ml = scan_meta(cb_meta, hdr.meta_len);
      if (ml.ok && !ml.to_python &&
          ml.attachment <= static_cast<long>(tb_iobuf_size(scratch))) {
        char full[256];
        size_t sl = ml.service.size(), mn = ml.method.size();
        if (sl + 1 + mn < sizeof full) {
          memcpy(full, ml.service.data(), sl);
          full[sl] = '.';
          memcpy(full + sl + 1, ml.method.data(), mn);
          size_t fn = sl + 1 + mn;
          full[fn] = '\0';
          uint64_t idx = 0;
          if (s->methods != nullptr &&
              tb_flatmap_get(s->methods, method_key(full, fn), &idx) == 1 &&
              s->native_methods[idx]->full_name == full) {
            // traced metas never seed the memo (see the PRPC loop: the
            // ids change per call and the memo'd ReqCtx carries none)
            if (ml.trace_id == 0 && ml.span_id == 0 && ml.log_id == 0 &&
                ml.parent_span_id == 0 && ml.sampled == 0) {
              c->memo_meta.assign(cb_meta, hdr.meta_len);
              c->memo_idx = idx;
              c->memo_attachment = ml.attachment;
              c->memo_timeout = ml.timeout_ms;
            }
            ReqCtx rc2{kProtoTbus, hdr.cid_lo, hdr.cid_hi,
                       hdr.flags & kFlagBodyCrc, ml.attachment,
                       ml.timeout_ms, 0,
                       ml.trace_id, ml.span_id, ml.sampled};
            run_native(c, s->native_methods[idx], rc2, scratch, batch);
            tb_iobuf_clear(scratch);
            continue;
          }
        }
      }
    }
    // python route (responses, streams, compressed, unknown methods —
    // admission/stats/errors stay consistent with the Python server path)
    s->cb_frames.fetch_add(1, std::memory_order_relaxed);
    if (s->frame_cb == nullptr) {
      if ((hdr.flags & kFlagResponse) == 0) {
        ReqCtx rc2{kProtoTbus, hdr.cid_lo, hdr.cid_hi, 0, 0, 0, 0};
        append_error(batch, rc2, s->errs.enomethod, "no such method");
      }
      tb_iobuf_clear(scratch);
      continue;
    }
    // the Python callee owns its body: hand it a fresh handle that
    // ref-shares the scratch's blocks (no byte copy), then reuse scratch
    tb_iobuf* body = tb_iobuf_create();
    tb_iobuf_append_iobuf(body, scratch);
    tb_iobuf_clear(scratch);
    s->frame_cb(s->frame_ctx, c->token, hdr.cid_lo, hdr.cid_hi,
                hdr.flags |
                    (c->authenticated.load(std::memory_order_relaxed)
                         ? kFlagConnAuthed
                         : 0),
                hdr.error_code, cb_meta, hdr.meta_len, body);
  }
}

// baidu_std cut + dispatch loop: the PRPC counterpart of the tbus loop
// above (reference ParseRpcMessage + ProcessRpcRequest,
// baidu_rpc_protocol.cpp:92-503), same batching/scratch discipline — one
// writev per readable burst, native methods answered without the
// interpreter, everything else one frame callback into Python.
FrameStatus process_frames_prpc(NetConn* c) {
  tb_server* s = c->srv;
  tb_iobuf* batch = c->loop->batch;      // reactor data pool (see tbus loop)
  tb_iobuf* scratch = c->loop->scratch;
  auto flush = [&](FrameStatus st) {
    if (tb_iobuf_size(batch) > 0) conn_queue_iobuf(c, batch);
    tb_iobuf_clear(batch);
    tb_iobuf_clear(scratch);
    return st;
  };
  for (;;) {
    uint32_t body_len = 0, meta_len = 0;
    int prc = prpc_peek(c->rbuf, &body_len, &meta_len, s->max_body);
    if (prc == 1) return flush(FrameStatus::kOk);
    if (prc != 0) {
      flush(FrameStatus::kKilled);  // earlier valid responses go out
      conn_destroy(c, true);
      return FrameStatus::kKilled;
    }
    if (tb_iobuf_size(c->rbuf) < kPrpcHeader + body_len)
      return flush(FrameStatus::kOk);
    char mstack[4096];
    std::string mheap;
    char* mptr = mstack;
    if (meta_len > sizeof mstack) {
      mheap.resize(meta_len);
      mptr = &mheap[0];
    }
    if (meta_len) tb_iobuf_copy_to(c->rbuf, mptr, meta_len, kPrpcHeader);
    tb_iobuf_popn(c->rbuf, kPrpcHeader + meta_len);
    tb_iobuf_cutn(c->rbuf, scratch, body_len - meta_len);
    PrpcMeta pm = scan_prpc_meta(mptr, meta_len);
    if (!pm.ok) {
      // meta that doesn't parse as proto2 at all: the stream is hopeless
      // (the Python plane's FatalParseError path)
      flush(FrameStatus::kKilled);
      conn_destroy(c, true);
      return FrameStatus::kKilled;
    }
    const long blen = static_cast<long>(tb_iobuf_size(scratch));
    if (!pm.is_response && !pm.to_python && pm.attachment <= blen) {
      // auth gate (reference: VerifyRpcRequest before ProcessRpcRequest,
      // baidu_rpc_protocol.cpp): verified ONCE per connection, verdict
      // cached on the conn; rejects answer the berror(ERPCAUTH) frame
      // byte-identically to the Python route and keep the conn open
      if (s->auth_enabled.load(std::memory_order_relaxed) &&
          !c->authenticated.load(std::memory_order_relaxed)) {
        if (verify_auth(s, c, pm.auth, pm.auth_len)) {
          c->authenticated.store(true, std::memory_order_relaxed);
        } else {
          s->auth_rejects.fetch_add(1, std::memory_order_relaxed);
          ReqCtx rc{kProtoPrpc, static_cast<uint32_t>(pm.cid),
                    static_cast<uint32_t>(pm.cid >> 32), 0, 0, 0, 0};
          append_error(batch, rc, s->errs.erpcauth, kUnauthorizedText);
          tb_iobuf_clear(scratch);
          continue;
        }
      }
      ReqCtx rc{kProtoPrpc, static_cast<uint32_t>(pm.cid),
                static_cast<uint32_t>(pm.cid >> 32), 0, pm.attachment,
                pm.timeout_ms, pm.compress,
                pm.trace_id, pm.span_id, pm.sampled};
      const bool traced = pm.trace_id != 0 || pm.span_id != 0 ||
                          pm.log_id != 0 || pm.parent_span_id != 0 ||
                          pm.sampled != 0;
      // memo keyed on the request submessage (cid lives outside it).
      // Traced submessages never enter the memo: the ids change per
      // call, and a byte-identical traced repeat hitting a memo seeded
      // by an UNTRACED frame would drop its trace context — so traced
      // frames always take the full lookup (they still stay native).
      if (c->memo_attachment >= 0 &&
          pm.req_sub_len == c->memo_meta.size() && pm.req_sub_len > 0 &&
          memcmp(pm.req_sub, c->memo_meta.data(), pm.req_sub_len) == 0) {
        run_native(c, s->native_methods[c->memo_idx], rc, scratch, batch);
        tb_iobuf_clear(scratch);
        continue;
      }
      // traced frames: the per-call span ids defeat the byte memo, so
      // route through the NAME-keyed memo (two memcmps) before paying
      // the full name join + flatmap probe
      if (traced && c->memo_name_idx >= 0 &&
          pm.svc_len == c->memo_svc.size() &&
          pm.mth_len == c->memo_mth.size() && pm.svc != nullptr &&
          pm.mth != nullptr &&
          memcmp(pm.svc, c->memo_svc.data(), pm.svc_len) == 0 &&
          memcmp(pm.mth, c->memo_mth.data(), pm.mth_len) == 0) {
        run_native(c, s->native_methods[c->memo_name_idx], rc, scratch,
                   batch);
        tb_iobuf_clear(scratch);
        continue;
      }
      char full[256];
      size_t sl = pm.svc_len, mn = pm.mth_len;
      if (pm.svc != nullptr && pm.mth != nullptr && sl + 1 + mn < sizeof full) {
        memcpy(full, pm.svc, sl);
        full[sl] = '.';
        memcpy(full + sl + 1, pm.mth, mn);
        size_t fn = sl + 1 + mn;
        full[fn] = '\0';
        uint64_t idx = 0;
        if (s->methods != nullptr &&
            tb_flatmap_get(s->methods, method_key(full, fn), &idx) == 1 &&
            s->native_methods[idx]->full_name == full) {
          if (!traced) {
            c->memo_meta.assign(pm.req_sub, pm.req_sub_len);
            c->memo_idx = idx;
            c->memo_attachment = 0;  // >=0 marks the memo live (PRPC mode)
          } else {
            c->memo_svc.assign(pm.svc, pm.svc_len);
            c->memo_mth.assign(pm.mth, pm.mth_len);
            c->memo_name_idx = static_cast<long>(idx);
          }
          run_native(c, s->native_methods[idx], rc, scratch, batch);
          tb_iobuf_clear(scratch);
          continue;
        }
      }
    }
    // python route: responses, compressed, traced, auth'd, streamed or
    // unknown-method frames — flag 0x100 tells the callee the meta is
    // RpcMeta proto bytes and the connection answers in PRPC
    s->cb_frames.fetch_add(1, std::memory_order_relaxed);
    uint32_t cb_flags = kFlagWirePrpc | (pm.is_response ? kFlagResponse : 0) |
                        (c->authenticated.load(std::memory_order_relaxed)
                             ? kFlagConnAuthed
                             : 0);
    if (s->frame_cb == nullptr) {
      if (!pm.is_response) {
        ReqCtx rc{kProtoPrpc, static_cast<uint32_t>(pm.cid),
                  static_cast<uint32_t>(pm.cid >> 32), 0, 0, 0, 0};
        append_error(batch, rc, s->errs.enomethod, "no such method");
      }
      tb_iobuf_clear(scratch);
      continue;
    }
    tb_iobuf* body = tb_iobuf_create();
    tb_iobuf_append_iobuf(body, scratch);
    tb_iobuf_clear(scratch);
    s->frame_cb(s->frame_ctx, c->token, static_cast<uint32_t>(pm.cid),
                static_cast<uint32_t>(pm.cid >> 32), cb_flags, pm.error_code,
                mptr, meta_len, body);
  }
}

void conn_readable(NetConn* c) {
  // one clock read per readable burst: the arrival baseline for the
  // deadline shed in run_native AND the idle-reap activity stamp
  c->last_active_ms.store(now_ms(), std::memory_order_relaxed);
  c->loop->inline_burst = 0;  // fresh pressure budget per readable burst
  size_t burst = tb_iobuf_read_burst();
  bool eof = false;
  for (;;) {
    long rc = tb_iobuf_append_from_fd(c->rbuf, c->fd, burst);
    if (rc > 0) {
      if (static_cast<size_t>(rc) < burst) break;
      continue;
    }
    if (rc == -EAGAIN || rc == -EWOULDBLOCK) break;
    if (rc == -EINTR) continue;
    eof = true;  // 0 = EOF; other negatives = read error
    break;
  }
  if (tb_iobuf_size(c->rbuf) > 0) {
    FrameStatus st = process_frames(c);
    if (st != FrameStatus::kOk) return;  // conn already gone
  }
  if (eof) conn_destroy(c, true);
}

void accept_ready(tb_server* s, Listener* lst) {
  for (;;) {
    if (s->accept_paused.load(std::memory_order_acquire)) return;
    int fd = accept4(lst->fd, nullptr, nullptr,
                     SOCK_NONBLOCK | SOCK_CLOEXEC);
    if (fd < 0) return;  // EAGAIN / EMFILE / EINTR: next event retries
    set_nodelay(fd);
    s->accepted.fetch_add(1, std::memory_order_relaxed);
    NetConn* c = new NetConn();
    c->last_active_ms.store(now_ms(), std::memory_order_relaxed);
    c->fd = fd;
    c->srv = s;
    // sharded at accept time, never migrates: round-robin assignment
    // keeps the distribution even regardless of which reactor's
    // SO_REUSEPORT listener the kernel handed the connection to
    c->loop = s->loops[s->next_loop.fetch_add(1) % s->loops.size()];
    c->loop->live_conns.fetch_add(1, std::memory_order_relaxed);
    c->rbuf = tb_iobuf_create();
    c->wbuf = tb_iobuf_create();
    conn_register(c);
    {
      std::lock_guard<std::mutex> g(c->loop->conns_mu);
      c->loop->conns.push_back(c);
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = static_cast<PollObj*>(c);
    if (epoll_ctl(c->loop->epfd, EPOLL_CTL_ADD, fd, &ev) != 0)
      conn_destroy(c, true);
  }
}

// fabricscan: role(loop)
void loop_run(tb_server* s, NetLoop* l) {
  epoll_event evs[128];
  while (!l->stopping.load(std::memory_order_acquire)) {
    int n = epoll_wait(l->epfd, evs, 128, 500);
    // lame-duck: every reactor owns its own listener's epoll
    // registration, so the actual teardown runs HERE on the owning loop
    // thread (no cross-thread epoll_ctl/close race with a concurrent
    // accept_ready)
    if (s->accept_paused.load(std::memory_order_acquire) &&
        l->listener.fd >= 0) {
      epoll_ctl(l->epfd, EPOLL_CTL_DEL, l->listener.fd, nullptr);
      close(l->listener.fd);
      l->listener.fd = -1;
    }
    for (int i = 0; i < n; ++i) {
      PollObj* o = static_cast<PollObj*>(evs[i].data.ptr);
      if (o == nullptr) continue;
      if (o->kind == 2) {  // wake
        uint64_t v;
        ssize_t r = read(static_cast<Wake*>(o)->fd, &v, sizeof v);
        (void)r;
        continue;
      }
      if (o->kind == 1) {  // listener (this reactor's own)
        accept_ready(s, static_cast<Listener*>(o));
        continue;
      }
      NetConn* c = static_cast<NetConn*>(o);
      uint32_t e = evs[i].events;
      if (e & (EPOLLERR | EPOLLHUP)) {
        conn_destroy(c, true);
        continue;
      }
      if (e & EPOLLOUT) {
        std::lock_guard<std::mutex> g(c->wmu);
        conn_flush_locked(c);
      }
      if (e & EPOLLIN) conn_readable(c);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// server C API
// ---------------------------------------------------------------------------

// fabricscan: role(init)
tb_server* tb_server_create(int nloops) {
  if (nloops < 1) nloops = 1;
  tb_server* s = new tb_server();
  s->methods = tb_flatmap_create(64);
  for (int i = 0; i < nloops; ++i) {
    NetLoop* l = new NetLoop();
    l->id = i;
    l->epfd = epoll_create1(EPOLL_CLOEXEC);
    l->wake.fd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    // reactor-owned data pools, reused across every burst the loop cuts
    l->batch = tb_iobuf_create();
    l->scratch = tb_iobuf_create();
    l->zctx = new ZCtx();
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = static_cast<PollObj*>(&l->wake);
    epoll_ctl(l->epfd, EPOLL_CTL_ADD, l->wake.fd, &ev);
    s->loops.push_back(l);
  }
  return s;
}

int tb_server_num_reactors(const tb_server* s) {
  return static_cast<int>(s->loops.size());
}

// fabricscan: role(init)
int tb_server_set_dispatch_pool(tb_server* s, int nworkers) {
  // pre-listen only: loop threads read s->pool / deques without fences
  if (s->listening) return -1;
  s->pool_workers = nworkers > 0 ? nworkers : 0;
  return 0;
}

int tb_server_set_native_long_running(tb_server* s, const char* full_name,
                                      int on) {
  for (NativeMethod* nm : s->native_methods) {
    if (nm->full_name == full_name) {
      nm->long_running.store(on ? 1u : 0u, std::memory_order_relaxed);
      return 0;
    }
  }
  return -1;
}

// fabricscan: role(init)
void tb_server_set_frame_cb(tb_server* s, tb_frame_fn cb, void* ctx) {
  s->frame_cb = cb;
  s->frame_ctx = ctx;
}

// fabricscan: role(init)
void tb_server_set_handoff_cb(tb_server* s, tb_handoff_fn cb, void* ctx) {
  s->handoff_cb = cb;
  s->handoff_ctx = ctx;
}

// fabricscan: role(init)
void tb_server_set_closed_cb(tb_server* s, tb_closed_fn cb, void* ctx) {
  s->closed_cb = cb;
  s->closed_ctx = ctx;
}

// fabricscan: role(init)
void tb_server_set_max_body(tb_server* s, size_t bytes) { s->max_body = bytes; }

// fabricscan: role(init)
void tb_server_set_compress_min_bytes(tb_server* s, size_t bytes) {
  s->compress_min = bytes;
}

// fabricscan: role(init)
void tb_server_set_max_decompress(tb_server* s, size_t bytes) {
  s->max_decompress = bytes != 0 ? bytes : static_cast<size_t>(-1);
}

// fabricscan: role(init)
int tb_server_set_auth(tb_server* s, tb_auth_fn fn, void* ud) {
  // pre-listen only: loop threads read auth_fn/auth_tokens without fences
  if (s->listening) return -1;
  s->auth_fn = fn;
  s->auth_ud = ud;
  s->auth_enabled.store(fn != nullptr || !s->auth_tokens.empty(),
                        std::memory_order_relaxed);
  return 0;
}

// fabricscan: role(init)
int tb_server_set_auth_tokens(tb_server* s, const char* blob,
                              size_t blob_len) {
  // blob = repeated [u32 LE length][bytes]; replaces the table wholesale.
  // Pre-listen only, like tb_server_set_auth.
  if (s->listening) return -1;
  std::vector<std::string> tokens;
  size_t off = 0;
  while (off < blob_len) {
    if (off + 4 > blob_len) return -1;
    uint32_t n = static_cast<uint8_t>(blob[off]) |
                 (static_cast<uint32_t>(static_cast<uint8_t>(blob[off + 1]))
                  << 8) |
                 (static_cast<uint32_t>(static_cast<uint8_t>(blob[off + 2]))
                  << 16) |
                 (static_cast<uint32_t>(static_cast<uint8_t>(blob[off + 3]))
                  << 24);
    off += 4;
    if (n > blob_len - off) return -1;
    tokens.emplace_back(blob + off, n);
    off += n;
  }
  s->auth_tokens = std::move(tokens);
  s->auth_enabled.store(s->auth_fn != nullptr || !s->auth_tokens.empty(),
                        std::memory_order_relaxed);
  return 0;
}

uint64_t tb_server_auth_rejects(const tb_server* s) {
  return s->auth_rejects.load(std::memory_order_relaxed);
}

void tb_server_compress_stats(const tb_server* s, uint64_t* in_wire,
                              uint64_t* in_raw, uint64_t* out_raw,
                              uint64_t* out_wire) {
  if (in_wire) *in_wire = s->c_in_wire.load(std::memory_order_relaxed);
  if (in_raw) *in_raw = s->c_in_raw.load(std::memory_order_relaxed);
  if (out_raw) *out_raw = s->c_out_raw.load(std::memory_order_relaxed);
  if (out_wire) *out_wire = s->c_out_wire.load(std::memory_order_relaxed);
}

namespace {

TelemetryRing* make_telemetry_ring(uint32_t capacity, uint32_t sample_every) {
  size_t cap = 64;
  while (cap < capacity && cap < (1u << 24)) cap <<= 1;
  TelemetryRing* r = new TelemetryRing();
  r->cells = new TelemetryCell[cap];
  for (size_t i = 0; i < cap; ++i)
    r->cells[i].seq.store(i, std::memory_order_relaxed);
  r->mask = cap - 1;
  r->sample_every = sample_every;
#if defined(__x86_64__)
  // tick->ns calibration: anchor now, short-baseline initial ratio (the
  // first drain refines it over its much longer window); server creation
  // is a once-per-port event, the 200 µs sleep is invisible there
  r->cal_ticks0 = telemetry_ticks();
  r->cal_mono0 = tb_monotonic_ns();
  usleep(200);
  uint64_t dt = telemetry_ticks() - r->cal_ticks0;
  uint64_t dm = tb_monotonic_ns() - r->cal_mono0;
  if (dt > 0 && dm > 0)
    r->ns_per_tick.store(static_cast<double>(dm) / static_cast<double>(dt),
                         std::memory_order_relaxed);
#else
  r->cal_ticks0 = r->cal_mono0 = tb_monotonic_ns();  // ticks ARE ns
#endif
  return r;
}

long ring_drain(TelemetryRing* r, tb_telemetry_record* out,
                size_t max_records) {
#if defined(__x86_64__)
  // refine the tick->ns ratio over the ever-growing anchor baseline,
  // then convert the popped records in place: start_ns becomes
  // CLOCK_MONOTONIC ns, latency_ns real ns — callers never see ticks
  uint64_t dt = telemetry_ticks() - r->cal_ticks0;
  uint64_t dm = tb_monotonic_ns() - r->cal_mono0;
  if (dt > 1000000 && dm > 0)
    r->ns_per_tick.store(static_cast<double>(dm) / static_cast<double>(dt),
                         std::memory_order_relaxed);
  const double npt = r->ns_per_tick.load(std::memory_order_relaxed);
  long kept = 0;
  long n;
  // re-pop while everything popped was discarded: a return of 0 must
  // mean "nothing left", or the caller's drain-until-0 loop strands the
  // valid records queued behind a fully clock-invalid batch
  do {
    n = telemetry_pop(r, out, max_records);
    for (long i = 0; i < n; ++i) {
      tb_telemetry_record rec = out[i];
      double lat = rec.latency_ns * npt;
      // a TSC hiccup (thread migrated onto an unsynced core mid-request)
      // shows as a wrapped/huge delta: DROP the record — a fabricated
      // 0-latency "success" would drag the min-latency EMA (and with it
      // the adaptive limit) toward zero on a healthy server.  Counted as
      // dropped so produced == drained + dropped accounting holds.
      if (!(lat >= 0 && lat < 60e9)) {
        r->dropped.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      rec.latency_ns = static_cast<uint64_t>(lat);
      rec.start_ns =
          rec.start_ns >= r->cal_ticks0
              ? r->cal_mono0 + static_cast<uint64_t>(
                                   (rec.start_ns - r->cal_ticks0) * npt)
              : r->cal_mono0;
      out[kept++] = rec;
    }
  } while (n > 0 && kept == 0);
  return kept;
#else
  return telemetry_pop(r, out, max_records);
#endif
}

}  // namespace

// fabricscan: role(init)
void tb_server_set_telemetry(tb_server* s, uint32_t capacity,
                             uint32_t sample_every) {
  // pre-listen only: the per-reactor ring pointers are published once,
  // so the loop threads never see a ring torn down under them
  if (capacity == 0 || s->telemetry_enabled) return;
  s->telemetry_enabled = true;
  for (NetLoop* l : s->loops)
    l->telemetry.store(make_telemetry_ring(capacity, sample_every),
                       std::memory_order_release);
}

long tb_server_drain_telemetry(tb_server* s, tb_telemetry_record* out,
                               size_t max_records) {
  if (out == nullptr || max_records == 0) return 0;
  long total = 0;
  for (NetLoop* l : s->loops) {
    TelemetryRing* r = l->telemetry.load(std::memory_order_acquire);
    if (r == nullptr) continue;
    total += ring_drain(r, out + total, max_records - total);
    if (static_cast<size_t>(total) >= max_records) break;
  }
  return total;
}

long tb_server_drain_telemetry_ring(tb_server* s, int reactor,
                                    tb_telemetry_record* out,
                                    size_t max_records) {
  if (reactor < 0 || static_cast<size_t>(reactor) >= s->loops.size())
    return -1;
  if (out == nullptr || max_records == 0) return 0;
  TelemetryRing* r =
      s->loops[reactor]->telemetry.load(std::memory_order_acquire);
  return r == nullptr ? 0 : ring_drain(r, out, max_records);
}

uint64_t tb_server_telemetry_dropped(const tb_server* s) {
  uint64_t total = 0;
  for (NetLoop* l : s->loops) {
    TelemetryRing* r = l->telemetry.load(std::memory_order_acquire);
    if (r != nullptr) total += r->dropped.load(std::memory_order_relaxed);
  }
  return total;
}

int tb_server_reactor_stats(const tb_server* s, int reactor,
                            uint64_t* live_conns, uint64_t* native_reqs,
                            uint64_t* telemetry_dropped) {
  if (reactor < 0 || static_cast<size_t>(reactor) >= s->loops.size())
    return -1;
  NetLoop* l = s->loops[reactor];
  if (live_conns) *live_conns = l->live_conns.load(std::memory_order_relaxed);
  if (native_reqs)
    *native_reqs = l->native_reqs.load(std::memory_order_relaxed);
  if (telemetry_dropped) {
    TelemetryRing* r = l->telemetry.load(std::memory_order_acquire);
    *telemetry_dropped =
        r == nullptr ? 0 : r->dropped.load(std::memory_order_relaxed);
  }
  return 0;
}

namespace {

int register_native_common(tb_server* s, const char* full_name, int kind,
                           tb_native_fn fn, void* ud,
                           uint32_t max_concurrency) {
  uint64_t key = method_key(full_name, strlen(full_name));
  uint64_t existing = 0;
  if (tb_flatmap_get(s->methods, key, &existing) == 1)
    return -1;  // double registration / key collision: keep the Python route
  NativeMethod* nm = new NativeMethod();
  nm->kind = kind;
  nm->fn = fn;
  nm->ud = ud;
  nm->max_concurrency.store(max_concurrency, std::memory_order_relaxed);
  nm->full_name = full_name;
  nm->index = static_cast<uint32_t>(s->native_methods.size());
  s->native_methods.push_back(nm);
  tb_flatmap_insert(s->methods, key, s->native_methods.size() - 1);
  return 0;
}

}  // namespace

int tb_server_set_native_max_concurrency(tb_server* s, const char* full_name,
                                         uint32_t max_concurrency) {
  // runtime retune of a natively-dispatched method's admission limit
  // (the Python plane's MaxConcurrencyOf setter must reach methods that
  // never touch the interpreter); nm->max_concurrency is read per
  // request, so the store takes effect on the next admission check
  for (NativeMethod* nm : s->native_methods) {
    if (nm->full_name == full_name) {
      nm->max_concurrency.store(max_concurrency, std::memory_order_relaxed);
      return 0;
    }
  }
  return -1;
}

long tb_server_get_native_max_concurrency(tb_server* s,
                                          const char* full_name) {
  for (NativeMethod* nm : s->native_methods) {
    if (nm->full_name == full_name)
      return static_cast<long>(
          nm->max_concurrency.load(std::memory_order_relaxed));
  }
  return -1;  // not natively registered
}

// fabricscan: role(init)
int tb_server_register_native(tb_server* s, const char* full_name, int kind,
                              uint32_t max_concurrency) {
  if (kind != kKindEcho && kind != kKindNop) return -1;
  return register_native_common(s, full_name, kind, nullptr, nullptr,
                                max_concurrency);
}

// fabricscan: role(init)
int tb_server_register_native_fn(tb_server* s, const char* full_name,
                                 tb_native_fn fn, void* ud,
                                 uint32_t max_concurrency) {
  if (fn == nullptr) return -1;
  return register_native_common(s, full_name, kKindCallback, fn, ud,
                                max_concurrency);
}

// fabricscan: role(init)
int tb_server_listen(tb_server* s, const char* ip, int port) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1) return -EINVAL;
  const bool reuseport = s->loops.size() > 1;
  // SO_REUSEPORT would also let an UNRELATED server (same uid) bind the
  // same explicit port — the kernel would then split connections between
  // the two with no error anywhere.  Keep the EADDRINUSE contract: probe
  // the requested port with a plain exclusive bind first (the tiny
  // close-to-rebind window can only turn into a clean bind failure
  // below, never into silent sharing with a server that was already
  // there).  Ephemeral binds (port 0) pick a free port by construction.
  if (reuseport && port != 0) {
    int probe = socket(AF_INET, SOCK_STREAM | SOCK_CLOEXEC, 0);
    if (probe < 0) return -errno;
    int one = 1;
    setsockopt(probe, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(probe, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0) {
      int e = errno;
      close(probe);
      return -e;
    }
    close(probe);
  }
  int bound_port = port;
  for (size_t i = 0; i < s->loops.size(); ++i) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) {
      if (i == 0) return -errno;
      break;  // reactors without a listener still get conns round-robin
    }
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    // per-reactor listeners on ONE port: the SO_REUSEPORT analog of the
    // reference's per-core EventDispatcher accept sharding.  Single-
    // reactor servers keep the plain bind (and its EADDRINUSE contract).
    if (reuseport) setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof one);
    addr.sin_port = htons(static_cast<uint16_t>(bound_port));
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0 ||
        listen(fd, 1024) != 0) {
      int e = errno;
      close(fd);
      if (i == 0) return -e;
      break;  // REUSEPORT unsupported: earlier listeners carry the load
    }
    if (i == 0) {
      socklen_t alen = sizeof addr;
      getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
      bound_port = ntohs(addr.sin_port);
    }
    s->loops[i]->listener.fd = fd;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = static_cast<PollObj*>(&s->loops[i]->listener);
    epoll_ctl(s->loops[i]->epfd, EPOLL_CTL_ADD, fd, &ev);
  }
  s->port = bound_port;
  s->listening = true;
  // dispatch pool: per-reactor deques + worker threads, started before
  // the loops so no push can beat the workers into existence
  if (s->pool_workers > 0) {
    for (NetLoop* l : s->loops) l->deque = new WorkDeque(8192);
    s->pool = new DispatchPool();
    for (int w = 0; w < s->pool_workers; ++w)
      s->pool->workers.emplace_back(pool_worker, s, static_cast<size_t>(w));
  }
  for (NetLoop* l : s->loops) l->th = std::thread(loop_run, s, l);
  return s->port;
}

int tb_server_port(const tb_server* s) { return s->port; }

// fabricscan: role(stop)
void tb_server_stop(tb_server* s) {
  if (s->stopped.exchange(true)) return;
  for (NetLoop* l : s->loops) {
    l->stopping.store(true, std::memory_order_release);
    uint64_t one = 1;
    ssize_t r = write(l->wake.fd, &one, sizeof one);
    (void)r;
  }
  for (NetLoop* l : s->loops)
    if (l->th.joinable()) l->th.join();
  for (NetLoop* l : s->loops) {
    if (l->listener.fd >= 0) {
      close(l->listener.fd);
      l->listener.fd = -1;
    }
  }
  // dispatch pool: stop workers, then run the stranded tasks on THIS
  // thread (loops are joined, so nobody else pushes; connections are
  // still alive, so the answers flush before the sweep below)
  if (s->pool != nullptr) {
    {
      std::lock_guard<std::mutex> g(s->pool->mu);
      s->pool->stopping.store(true, std::memory_order_release);
    }
    s->pool->cv.notify_all();
    for (std::thread& t : s->pool->workers)
      if (t.joinable()) t.join();
    for (NetLoop* l : s->loops) {
      uint64_t v = 0;
      while (l->deque->pop(&v))
        run_pool_task(reinterpret_cast<WorkTask*>(v));
    }
  }
  // loops are quiescent: sweep remaining conns single-threaded
  for (NetLoop* l : s->loops) {
    std::vector<NetConn*> left;
    {
      std::lock_guard<std::mutex> g(l->conns_mu);
      left = l->conns;
    }
    for (NetConn* c : left) conn_destroy(c, true);
  }
}

// fabricscan: role(stop)
void tb_server_destroy(tb_server* s) {
  tb_server_stop(s);
  for (NetLoop* l : s->loops) {
    close(l->wake.fd);
    close(l->epfd);
    tb_iobuf_destroy(l->batch);
    tb_iobuf_destroy(l->scratch);
    delete l->zctx;
    delete l->telemetry.load(std::memory_order_relaxed);
    delete l->deque;
    delete l;
  }
  for (NativeMethod* nm : s->native_methods) delete nm;
  tb_flatmap_destroy(s->methods);
  delete s->pool;
  delete s;
}

void tb_server_stats(const tb_server* s, uint64_t* accepted,
                     uint64_t* native_reqs, uint64_t* cb_frames,
                     uint64_t* handoffs, uint64_t* live_conns) {
  if (accepted) *accepted = s->accepted.load();
  if (native_reqs) {
    uint64_t total = 0;
    for (NetLoop* l : s->loops)
      total += l->native_reqs.load(std::memory_order_relaxed);
    *native_reqs = total;
  }
  if (cb_frames) *cb_frames = s->cb_frames.load();
  if (handoffs) *handoffs = s->handoffs.load();
  if (live_conns) {
    uint64_t total = 0;
    for (NetLoop* l : s->loops)
      total += l->live_conns.load(std::memory_order_relaxed);
    *live_conns = total;
  }
}

uint64_t tb_server_deadline_sheds(const tb_server* s) {
  return s->deadline_sheds.load(std::memory_order_relaxed);
}

void tb_server_pause_accept(tb_server* s) {
  if (s->accept_paused.exchange(true)) return;
  // wake EVERY loop: each reactor tears down its own listener on its own
  // thread at the next wakeup (no single-loop assumption)
  for (NetLoop* l : s->loops) {
    uint64_t one = 1;
    ssize_t r = write(l->wake.fd, &one, sizeof one);
    (void)r;
  }
}

long tb_server_close_idle(tb_server* s, uint64_t idle_ms) {
  // idle reap for native ports (reference Acceptor::CloseIdleConnections,
  // acceptor.cpp:111): shutdown() is the thread-safe kill — the owning
  // loop thread reaps the connection via EPOLLHUP, exactly the
  // tb_conn_close discipline.  Returns the number of connections culled.
  if (s->stopped.load(std::memory_order_acquire)) return 0;
  uint64_t cutoff = now_ms();
  long culled = 0;
  for (NetLoop* l : s->loops) {
    std::lock_guard<std::mutex> g(l->conns_mu);
    for (NetConn* c : l->conns) {
      if (c->dead.load(std::memory_order_acquire)) continue;
      uint64_t last = c->last_active_ms.load(std::memory_order_relaxed);
      if (last != 0 && cutoff > last && cutoff - last >= idle_ms) {
        shutdown(c->fd, SHUT_RDWR);
        ++culled;
      }
    }
  }
  return culled;
}

// ---------------------------------------------------------------------------
// per-connection API (token-addressed; any thread)
// ---------------------------------------------------------------------------

int tb_conn_respond(uint64_t token, const void* meta, size_t meta_len,
                    const void* payload, size_t payload_len, const void* att,
                    size_t att_len, uint32_t cid_lo, uint32_t cid_hi,
                    uint32_t flags, uint32_t error_code) {
  NetConn* c = conn_resolve(token);
  if (c == nullptr) return -1;
  tb_iobuf* out = tb_iobuf_create();
  pack_flat(out, meta, meta_len, payload, payload_len, att, att_len, cid_lo,
            cid_hi, flags | kFlagResponse, error_code);
  conn_queue_iobuf(c, out);
  tb_iobuf_destroy(out);
  conn_unref(c);
  return 0;
}

int tb_conn_write(uint64_t token, const tb_iobuf* data) {
  NetConn* c = conn_resolve(token);
  if (c == nullptr) return -1;
  conn_queue_iobuf(c, data);
  conn_unref(c);
  return 0;
}

int tb_conn_peer(uint64_t token, char* ip_out, size_t ip_cap) {
  NetConn* c = conn_resolve(token);
  if (c == nullptr) return -1;
  sockaddr_in addr{};
  socklen_t alen = sizeof addr;
  int port = -1;
  if (getpeername(c->fd, reinterpret_cast<sockaddr*>(&addr), &alen) == 0 &&
      addr.sin_family == AF_INET) {
    if (ip_out && ip_cap > 0) inet_ntop(AF_INET, &addr.sin_addr, ip_out, ip_cap);
    port = ntohs(addr.sin_port);
  }
  conn_unref(c);
  return port;
}

int tb_conn_close(uint64_t token) {
  NetConn* c = conn_resolve(token);
  if (c == nullptr) return -1;
  shutdown(c->fd, SHUT_RDWR);  // the loop thread reaps via EPOLLHUP
  conn_unref(c);
  return 0;
}

int tb_conn_set_authenticated(uint64_t token) {
  // the Python route verified this connection's credential (server_check)
  // — cache the verdict natively so the conn's later frames ride the
  // fast path without re-fighting auth
  NetConn* c = conn_resolve(token);
  if (c == nullptr) return -1;
  c->authenticated.store(true, std::memory_order_relaxed);
  conn_unref(c);
  return 0;
}

// ---------------------------------------------------------------------------
// client channel
// ---------------------------------------------------------------------------

namespace {

struct Pending {
  bool targeted;  // fabricscan: owner(shared)
  bool done = false;  // fabricscan: owner(shared)
  uint32_t err_code = 0;  // fabricscan: owner(shared)
  int fail = 0;   // -errno when the channel died under us  // fabricscan: owner(shared)
  std::string meta;  // fabricscan: owner(shared)
  tb_iobuf* body;  // targeted: caller's out buffer; any-mode: owned temp  // fabricscan: owner(shared)
};

}  // namespace

struct tb_channel {
  int fd = -1;  // fabricscan: owner(init)
  int proto = 0;  // 0 = tbus_std, 1 = baidu_std (PRPC)  // fabricscan: owner(init)
  // client reactor shard, pinned at connect: the top 8 bits of every cid
  // this channel mints carry it, so completions route to the owning
  // channel's pending table without any cross-channel map and a frame
  // carrying another shard's tag is detectably misrouted
  uint32_t shard = 0;  // fabricscan: owner(init)
  std::atomic<uint64_t> cid_misroutes{0};
  std::mutex wmu;  // writers (pack + writev serialize)
  std::mutex rmu;  // reader election
  std::mutex pmu;  // pending table + done queue + cv
  std::condition_variable pcv;
  std::unordered_map<uint64_t, Pending*> pending;  // fabricscan: owner(shared)
  std::deque<std::pair<uint64_t, Pending*>> doneq;  // any-mode completions  // fabricscan: owner(shared)
  std::atomic<uint64_t> next_cid{1};
  tb_iobuf* rbuf = nullptr;  // fabricscan: owner(shared)
  tb_iobuf* pump_body = nullptr;  // reused per-response cut target (pump)  // fabricscan: owner(shared)
  std::atomic<int> err{0};  // sticky -errno
  // counter-scheduled fault injection (tb_channel_set_fault): the native
  // analog of the Python Socket.write seam — every fail_every'th call
  // answers fault_err_code without touching the wire, every
  // close_every'th kills the connection mid-run, every delay_every'th
  // sleeps delay_ms first.  All zero = disabled (the steady-state cost
  // is one load).
  std::atomic<uint64_t> fault_counter{0};
  uint32_t fault_fail_every = 0;  // fabricscan: owner(init)
  uint32_t fault_close_every = 0;  // fabricscan: owner(init)
  uint32_t fault_delay_every = 0;  // fabricscan: owner(init)
  uint32_t fault_delay_ms = 0;  // fabricscan: owner(init)
  uint32_t fault_err_code = 0;  // fabricscan: owner(init)
  // production-shaped request stamping (baidu_std only; set before
  // concurrent use, like the fault schedule): a channel-default
  // compress_type spliced into RpcMeta field 3 (per-call override rides
  // flags_extra), and the credential for field 7 — stamped until the
  // first successful response proves the connection (the reference's
  // first-request auth fight), then omitted.
  uint32_t req_compress = 0;  // fabricscan: owner(init)
  std::string auth_data;  // fabricscan: owner(init)
  std::atomic<bool> auth_proven{false};
  // ambient trace context for the pipelined pump (tb_channel_set_trace):
  // every trace_every'th pump frame carries the Dapper fields in its
  // RpcRequestMeta, span_id incremented per traced frame — counter-
  // scheduled exact-rate like the fault seam.  Set before concurrent use.
  uint64_t tr_log_id = 0;  // fabricscan: owner(init)
  uint64_t tr_trace_id = 0;  // fabricscan: owner(init)
  uint64_t tr_span_id = 0;  // fabricscan: owner(init)
  uint64_t tr_parent_span_id = 0;  // fabricscan: owner(init)
  int tr_sampled = 0;  // fabricscan: owner(init)
  uint32_t trace_every = 0;  // 0 = untraced pump  // fabricscan: owner(init)
};

namespace {

// cid space partition: top 8 bits = client reactor shard, low 56 bits =
// the channel's sequence.  56 bits of sequence cannot wrap in practice.
constexpr int kCidShardShift = 56;
constexpr uint64_t kCidSeqMask = (1ull << kCidShardShift) - 1;
std::atomic<uint32_t> g_next_client_shard{0};

uint64_t channel_next_cid(tb_channel* ch) {
  return (static_cast<uint64_t>(ch->shard) << kCidShardShift) |
         (ch->next_cid.fetch_add(1, std::memory_order_relaxed) & kCidSeqMask);
}

// Validate an inbound cid's shard tag.  Returns the cid to complete
// (re-tagged to the local shard on mismatch) and sets *misroute — the
// caller fails the re-tagged pending with -EBADMSG instead of letting a
// corrupted tag strand its caller until timeout.
uint64_t channel_check_cid(tb_channel* ch, uint64_t cid, bool* misroute) {
  if ((cid >> kCidShardShift) == ch->shard) {
    *misroute = false;
    return cid;
  }
  *misroute = true;
  ch->cid_misroutes.fetch_add(1, std::memory_order_relaxed);
  return (static_cast<uint64_t>(ch->shard) << kCidShardShift) |
         (cid & kCidSeqMask);
}

void channel_fail(tb_channel* ch, int err) {
  ch->err.store(err, std::memory_order_release);
  std::lock_guard<std::mutex> g(ch->pmu);
  for (auto& kv : ch->pending) {
    if (!kv.second->done) {
      kv.second->done = true;
      kv.second->fail = err;
      if (!kv.second->targeted) ch->doneq.emplace_back(kv.first, kv.second);
    }
  }
  ch->pcv.notify_all();
}

// Cut one complete PRPC response off ch->rbuf.  Returns 1 when a frame
// was consumed (fills cid/meta/err_code and cuts payload+attachment into
// the pending's dst under pmu — same locking contract as the tbus path),
// 0 when incomplete, -EPROTO on garbage.  Caller holds rmu.
// fabricscan: locked
int prpc_complete_one(tb_channel* ch) {
  uint32_t body_len = 0, meta_len = 0;
  int prc = prpc_peek(ch->rbuf, &body_len, &meta_len, kClientMaxBody);
  if (prc == 1) return 0;
  if (prc != 0) return -EPROTO;
  if (tb_iobuf_size(ch->rbuf) < kPrpcHeader + body_len) return 0;
  std::string meta(meta_len, '\0');
  if (meta_len) tb_iobuf_copy_to(ch->rbuf, &meta[0], meta_len, kPrpcHeader);
  PrpcMeta pm = scan_prpc_meta(meta.data(), meta_len);
  if (!pm.ok) return -EPROTO;
  size_t rest = body_len - meta_len;
  bool mis = false;
  uint64_t cid = channel_check_cid(ch, pm.cid, &mis);
  {
    // completion runs under pmu so a timed-out caller can't free its
    // Pending (or its body iobuf) while the cut writes into it
    std::unique_lock<std::mutex> pl(ch->pmu);
    auto it = ch->pending.find(cid);
    Pending* p = it == ch->pending.end() ? nullptr : it->second;
    // a wrong-shard frame's payload never reaches the caller's buffer:
    // the pending (located by re-tagged sequence) fails with -EBADMSG
    tb_iobuf* dst =
        (p != nullptr && p->targeted && !mis) ? p->body : tb_iobuf_create();
    tb_iobuf_popn(ch->rbuf, kPrpcHeader + meta_len);
    if (rest) tb_iobuf_cutn(ch->rbuf, dst, rest);
    if (p == nullptr) {
      tb_iobuf_destroy(dst);  // timed-out caller already left: drop
    } else if (mis) {
      tb_iobuf_destroy(dst);
      p->fail = -EBADMSG;  // surfaced as EREQUEST by the Python plane
      if (!p->targeted) ch->doneq.emplace_back(cid, p);
      p->done = true;
      ch->pcv.notify_all();
    } else {
      p->meta = std::move(meta);
      p->err_code = pm.error_code;
      if (!p->targeted) {
        p->body = dst;
        ch->doneq.emplace_back(cid, p);
      }
      p->done = true;
      ch->pcv.notify_all();
    }
  }
  return 1;
}

// read whatever arrives within `slice_ms`, completing pendings.  Caller
// holds rmu.  Returns false when the channel failed.
// fabricscan: locked
bool pump_once(tb_channel* ch, int slice_ms) {
  pollfd pf{ch->fd, POLLIN, 0};
  int rc = poll(&pf, 1, slice_ms);
  if (rc < 0) {
    if (errno == EINTR) return true;
    channel_fail(ch, -errno);
    return false;
  }
  if (rc == 0) return true;
  size_t burst = tb_iobuf_read_burst();
  for (;;) {
    long n = tb_iobuf_append_from_fd(ch->rbuf, ch->fd, burst);
    if (n > 0) {
      if (static_cast<size_t>(n) < burst) break;
      continue;
    }
    if (n == -EAGAIN || n == -EWOULDBLOCK) break;
    if (n == -EINTR) continue;
    channel_fail(ch, n == 0 ? -EPIPE : static_cast<int>(n));
    return false;
  }
  if (ch->proto == 1) {
    for (;;) {
      int rc2 = prpc_complete_one(ch);
      if (rc2 == 0) break;
      if (rc2 < 0) {
        channel_fail(ch, rc2);
        return false;
      }
    }
    return true;
  }
  for (;;) {
    tb_tbus_hdr hdr;
    int prc = tb_tbus_peek(ch->rbuf, &hdr);
    if (prc == 1) break;
    if (prc == -1 || hdr.meta_len > hdr.body_len ||
        hdr.body_len > kClientMaxBody) {
      channel_fail(ch, -EPROTO);
      return false;
    }
    if (tb_iobuf_size(ch->rbuf) < kHeader + hdr.body_len) break;
    uint64_t wire_cid = static_cast<uint64_t>(hdr.cid_lo) |
                        (static_cast<uint64_t>(hdr.cid_hi) << 32);
    bool mis = false;
    uint64_t cid = channel_check_cid(ch, wire_cid, &mis);
    std::string meta(hdr.meta_len, '\0');
    bool proto_err = false;
    {
      // completion runs under pmu so a timed-out caller can't free its
      // Pending (or its body iobuf) while the cut writes into it
      std::unique_lock<std::mutex> pl(ch->pmu);
      auto it = ch->pending.find(cid);
      Pending* p = it == ch->pending.end() ? nullptr : it->second;
      tb_iobuf* dst =
          (p != nullptr && p->targeted && !mis) ? p->body : tb_iobuf_create();
      int crc =
          tb_tbus_cut(ch->rbuf, &hdr, meta.empty() ? nullptr : &meta[0], dst);
      if (crc != 0) {
        if (p == nullptr || !p->targeted || mis) tb_iobuf_destroy(dst);
        proto_err = true;
      } else if (p == nullptr) {
        tb_iobuf_destroy(dst);  // timed-out caller already left: drop
      } else if (mis) {
        // wrong-shard tag: the re-tagged pending fails -EBADMSG (the
        // Python plane answers EREQUEST); the channel itself survives
        tb_iobuf_destroy(dst);
        p->fail = -EBADMSG;
        if (!p->targeted) ch->doneq.emplace_back(cid, p);
        p->done = true;
        ch->pcv.notify_all();
      } else {
        p->meta = std::move(meta);
        p->err_code = hdr.error_code;
        if (!p->targeted) {
          p->body = dst;
          ch->doneq.emplace_back(cid, p);
        }
        p->done = true;
        ch->pcv.notify_all();
      }
    }
    if (proto_err) {
      channel_fail(ch, -EPROTO);
      return false;
    }
  }
  return true;
}

// blocking full write of `frame` under wmu with a deadline
int write_frame(tb_channel* ch, tb_iobuf* frame, uint64_t deadline) {
  std::lock_guard<std::mutex> g(ch->wmu);
  while (tb_iobuf_size(frame) > 0) {
    long rc = tb_iobuf_cut_into_fd(frame, ch->fd, 4u << 20);
    if (rc > 0) continue;
    if (rc == -EINTR) continue;
    if (rc == 0 || rc == -EAGAIN || rc == -EWOULDBLOCK) {
      uint64_t now = now_ms();
      if (now >= deadline) return -ETIMEDOUT;
      pollfd pf{ch->fd, POLLOUT, 0};
      poll(&pf, 1, static_cast<int>(deadline - now));
      continue;
    }
    return static_cast<int>(rc);
  }
  return 0;
}

// pack with an explicit cid and write fully; 0 ok, -errno otherwise
int channel_send_cid(tb_channel* ch, uint64_t cid, const void* meta,
                     size_t meta_len, const void* payload, size_t payload_len,
                     const void* att, size_t att_len, uint32_t flags_extra,
                     uint64_t deadline) {
  tb_iobuf* frame = tb_iobuf_create();
  if (ch->proto == 1) {
    // meta = RpcRequestMeta submessage.  In PRPC mode flags_extra's low
    // bits carry a per-call compress_type (0 = the channel default) —
    // the tbus flag space is meaningless here, so the argument is free
    // for race-free per-call codec selection.  The credential stamps
    // until the connection is proven.
    uint32_t compress =
        (flags_extra & 0xFu) != 0 ? (flags_extra & 0xFu) : ch->req_compress;
    const bool stamp_auth =
        !ch->auth_data.empty() &&
        !ch->auth_proven.load(std::memory_order_relaxed);
    pack_prpc_request(frame, meta, meta_len, payload, payload_len, att,
                      att_len, cid, compress,
                      stamp_auth ? ch->auth_data.data() : nullptr,
                      stamp_auth ? ch->auth_data.size() : 0);
  } else
    pack_flat(frame, meta, meta_len, payload, payload_len, att, att_len,
              static_cast<uint32_t>(cid), static_cast<uint32_t>(cid >> 32),
              flags_extra, 0);
  int rc = write_frame(ch, frame, deadline);
  tb_iobuf_destroy(frame);
  if (rc != 0 && rc != -ETIMEDOUT) channel_fail(ch, rc);
  return rc;
}

// shared wait-or-pump loop: wait until pred() under pmu, electing a reader
// to pump completions when nobody else is.  Returns false on deadline.
template <typename Pred>
bool wait_or_pump(tb_channel* ch, std::unique_lock<std::mutex>& pl,
                  uint64_t deadline, Pred pred) {
  while (!pred()) {
    if (ch->err.load(std::memory_order_acquire) != 0) return true;
    uint64_t now = now_ms();
    if (now >= deadline) return false;
    if (ch->rmu.try_lock()) {
      pl.unlock();
      int slice = static_cast<int>(std::min<uint64_t>(deadline - now, 50));
      pump_once(ch, slice);
      ch->rmu.unlock();
      pl.lock();
      ch->pcv.notify_all();
    } else {
      ch->pcv.wait_for(pl, std::chrono::milliseconds(10));
    }
  }
  return true;
}

}  // namespace

// fabricscan: role(init)
tb_channel* tb_channel_connect(const char* ip, int port, int timeout_ms,
                               int* err_out) {
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd < 0) {
    if (err_out) *err_out = errno;
    return nullptr;
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, ip, &addr.sin_addr) != 1) {
    close(fd);
    if (err_out) *err_out = EINVAL;
    return nullptr;
  }
  int rc = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr);
  if (rc != 0 && errno == EINPROGRESS) {
    pollfd pf{fd, POLLOUT, 0};
    rc = poll(&pf, 1, timeout_ms > 0 ? timeout_ms : 5000);
    if (rc == 1) {
      int soerr = 0;
      socklen_t slen = sizeof soerr;
      getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &slen);
      rc = soerr == 0 ? 0 : -1;
      errno = soerr;
    } else {
      rc = -1;
      errno = ETIMEDOUT;
    }
  }
  if (rc != 0) {
    if (err_out) *err_out = errno;
    close(fd);
    return nullptr;
  }
  set_nodelay(fd);
  set_nonblock(fd);
  tb_channel* ch = new tb_channel();
  ch->fd = fd;
  // pin to a client reactor shard (round-robin over the process): the
  // shard tag partitions the cid space so completions route without any
  // cross-channel shared map
  ch->shard = g_next_client_shard.fetch_add(1, std::memory_order_relaxed) &
              0xFFu;
  ch->rbuf = tb_iobuf_create();
  return ch;
}

int tb_channel_reactor(const tb_channel* ch) {
  return static_cast<int>(ch->shard);
}

uint64_t tb_channel_cid_misroutes(const tb_channel* ch) {
  return ch->cid_misroutes.load(std::memory_order_relaxed);
}

// fabricscan: role(init)
int tb_channel_set_protocol(tb_channel* ch, int proto) {
  if (proto != 0 && proto != 1) return -1;
  ch->proto = proto;
  return 0;
}

// fabricscan: role(init)
int tb_channel_set_compress(tb_channel* ch, int compress_type) {
  // channel-default request compress_type (baidu_std RpcMeta field 3);
  // the CALLER compresses payloads with the matching codec — this only
  // stamps the wire field.  Set before concurrent use.
  if (compress_type < 0 || compress_type > 3) return -1;
  ch->req_compress = static_cast<uint32_t>(compress_type);
  return 0;
}

// fabricscan: role(init)
int tb_channel_set_auth(tb_channel* ch, const void* data, size_t len) {
  // credential for RpcMeta field 7, stamped on requests until the first
  // successful response proves the connection.  Set before concurrent
  // use (a redial mints a fresh channel and re-arms it).
  if (data == nullptr || len == 0) {
    ch->auth_data.clear();
  } else {
    ch->auth_data.assign(static_cast<const char*>(data), len);
    ch->auth_proven.store(false, std::memory_order_relaxed);
  }
  return 0;
}

// fabricscan: role(init)
int tb_channel_set_fault(tb_channel* ch, uint32_t fail_every,
                         uint32_t close_every, uint32_t delay_every,
                         uint32_t delay_ms, uint32_t err_code) {
  // set BEFORE concurrent calls (rpc_press arms at channel creation);
  // the schedule fields are plain stores read by callers afterwards
  ch->fault_fail_every = fail_every;
  ch->fault_close_every = close_every;
  ch->fault_delay_every = delay_every;
  ch->fault_delay_ms = delay_ms;
  ch->fault_err_code = err_code != 0 ? err_code : 2001;  // EINTERNAL
  return 0;
}

// fabricscan: role(init)
int tb_channel_set_trace(tb_channel* ch, uint64_t log_id, uint64_t trace_id,
                         uint64_t span_id, uint64_t parent_span_id,
                         int sampled, uint32_t every) {
  // trace fields ride the PRPC RpcRequestMeta; the tbus pump's meta is
  // caller-built JSON, so a traced tbus pump has no seam here
  if (every != 0 && ch->proto != 1) return -1;
  ch->tr_log_id = log_id;
  ch->tr_trace_id = trace_id;
  ch->tr_span_id = span_id;
  ch->tr_parent_span_id = parent_span_id;
  ch->tr_sampled = sampled != 0 ? 1 : 0;
  ch->trace_every = every;
  return 0;
}

long tb_channel_call(tb_channel* ch, const void* meta, size_t meta_len,
                     const void* payload, size_t payload_len, const void* att,
                     size_t att_len, uint32_t flags_extra, tb_iobuf* body_out,
                     void* meta_out, size_t meta_cap, uint32_t* meta_len_out,
                     uint32_t* err_code_out, int timeout_ms) {
  int sticky = ch->err.load(std::memory_order_acquire);
  if (sticky != 0) return sticky;
  if (ch->fault_fail_every || ch->fault_close_every || ch->fault_delay_every) {
    // deterministic injection (counter schedule, not RNG — the same call
    // sequence injects the same faults, the FaultInjector discipline)
    uint64_t n = ch->fault_counter.fetch_add(1, std::memory_order_relaxed) + 1;
    if (ch->fault_close_every && n % ch->fault_close_every == 0) {
      // kill the connection mid-run: the write below fails and the
      // caller's redial machinery owns recovery (the socket-seam
      // ACTION_CLOSE analog)
      shutdown(ch->fd, SHUT_RDWR);
    } else if (ch->fault_fail_every && n % ch->fault_fail_every == 0) {
      // a completed-but-failed RPC, channel intact: the server "browned
      // out" this one call
      if (err_code_out) *err_code_out = ch->fault_err_code;
      if (meta_len_out) *meta_len_out = 0;
      return 0;
    }
    if (ch->fault_delay_every && n % ch->fault_delay_every == 0 &&
        ch->fault_delay_ms > 0) {
      usleep(static_cast<useconds_t>(ch->fault_delay_ms) * 1000);
    }
  }
  uint64_t deadline = now_ms() + (timeout_ms > 0 ? timeout_ms : 60000);
  uint64_t cid = channel_next_cid(ch);
  Pending p;
  p.targeted = true;
  p.body = body_out;
  {
    std::lock_guard<std::mutex> g(ch->pmu);
    ch->pending.emplace(cid, &p);
  }
  int rc = channel_send_cid(ch, cid, meta, meta_len, payload, payload_len, att,
                            att_len, flags_extra, deadline);
  if (rc != 0) {
    std::lock_guard<std::mutex> g(ch->pmu);
    ch->pending.erase(cid);
    return rc;
  }
  std::unique_lock<std::mutex> pl(ch->pmu);
  bool in_time = wait_or_pump(ch, pl, deadline, [&] { return p.done; });
  ch->pending.erase(cid);
  if (!in_time) return -ETIMEDOUT;
  if (!p.done) {  // channel failed before completion
    int e = ch->err.load(std::memory_order_acquire);
    return e != 0 ? e : -EPIPE;
  }
  int fail = p.fail;
  std::string meta_resp = std::move(p.meta);
  uint32_t ec = p.err_code;
  pl.unlock();
  if (fail != 0) return fail;
  // an accepted response proves the connection: later requests stop
  // stamping the credential (an ERPCAUTH reject must NOT prove it — the
  // next attempt still needs the credential on the wire)
  if (ec == 0) ch->auth_proven.store(true, std::memory_order_relaxed);
  if (meta_len_out)
    *meta_len_out = static_cast<uint32_t>(std::min(meta_resp.size(), meta_cap));
  if (meta_out && meta_cap > 0 && !meta_resp.empty())
    memcpy(meta_out, meta_resp.data(), std::min(meta_resp.size(), meta_cap));
  if (err_code_out) *err_code_out = ec;
  return static_cast<long>(tb_iobuf_size(body_out));
}

uint64_t tb_channel_send(tb_channel* ch, const void* meta, size_t meta_len,
                         const void* payload, size_t payload_len,
                         const void* att, size_t att_len, uint32_t flags_extra,
                         int* err_out) {
  int sticky = ch->err.load(std::memory_order_acquire);
  if (sticky != 0) {
    if (err_out) *err_out = -sticky;
    return 0;
  }
  uint64_t cid = channel_next_cid(ch);
  Pending* p = new Pending();
  p->targeted = false;
  p->body = nullptr;
  {
    std::lock_guard<std::mutex> g(ch->pmu);
    ch->pending.emplace(cid, p);
  }
  int rc = channel_send_cid(ch, cid, meta, meta_len, payload, payload_len, att,
                            att_len, flags_extra, now_ms() + 60000);
  if (rc != 0) {
    std::lock_guard<std::mutex> g(ch->pmu);
    auto it = ch->pending.find(cid);
    if (it != ch->pending.end() && it->second == p && !p->done) {
      ch->pending.erase(it);
      delete p;
    }  // else channel_fail moved it to doneq: recv() frees it
    if (err_out) *err_out = -rc;
    return 0;
  }
  return cid;
}

long tb_channel_recv(tb_channel* ch, uint64_t* cid_out, tb_iobuf* body_out,
                     void* meta_out, size_t meta_cap, uint32_t* meta_len_out,
                     uint32_t* err_code_out, int timeout_ms) {
  uint64_t deadline = now_ms() + (timeout_ms > 0 ? timeout_ms : 60000);
  std::unique_lock<std::mutex> pl(ch->pmu);
  for (;;) {
    if (!ch->doneq.empty()) {
      auto [cid, p] = ch->doneq.front();
      ch->doneq.pop_front();
      ch->pending.erase(cid);
      pl.unlock();
      long n;
      if (p->fail != 0) {
        n = p->fail;
      } else {
        if (cid_out) *cid_out = cid;
        if (meta_len_out)
          *meta_len_out =
              static_cast<uint32_t>(std::min(p->meta.size(), meta_cap));
        if (meta_out && meta_cap > 0 && !p->meta.empty())
          memcpy(meta_out, p->meta.data(), std::min(p->meta.size(), meta_cap));
        if (err_code_out) *err_code_out = p->err_code;
        n = 0;
        if (p->body != nullptr) {
          n = static_cast<long>(tb_iobuf_size(p->body));
          tb_iobuf_append_iobuf(body_out, p->body);
        }
      }
      if (p->body != nullptr) tb_iobuf_destroy(p->body);
      delete p;
      return n;
    }
    int sticky = ch->err.load(std::memory_order_acquire);
    if (sticky != 0) {
      pl.unlock();
      return sticky;
    }
    if (!wait_or_pump(ch, pl, deadline, [&] { return !ch->doneq.empty(); })) {
      pl.unlock();
      return -ETIMEDOUT;
    }
  }
}

int tb_channel_error(const tb_channel* ch) {
  return ch->err.load(std::memory_order_acquire);
}

long tb_channel_pump(tb_channel* ch, const void* meta, size_t meta_len,
                     const void* payload, size_t payload_len, int n,
                     int inflight, int timeout_ms) {
  if (n <= 0) return -EINVAL;
  if (inflight < 1) inflight = 1;
  std::lock_guard<std::mutex> rg(ch->rmu);
  std::lock_guard<std::mutex> wg(ch->wmu);
  int sticky = ch->err.load(std::memory_order_acquire);
  if (sticky != 0) return sticky;
  uint64_t deadline = now_ms() + (timeout_ms > 0 ? timeout_ms : 60000);
  size_t burst = tb_iobuf_read_burst();
  tb_iobuf* frame = tb_iobuf_create();
  int sent = 0, done = 0, outstanding = 0;
  long result = 0;
  // every frame of the pump is identical except the correlation id: build
  // the wire bytes ONCE (header + meta + payload, meta crc precomputed)
  // and per request patch the cid bytes + one append — no per-request
  // crc, header build, or multi-append.  PRPC carries the cid as a meta
  // varint, so the template encodes it as a padded 10-byte varint (fixed
  // width => patchable in place; decoders accept non-minimal varints).
  std::vector<char> tmpl;
  size_t cid_off = 12;  // tbus: header words 3-4
  if (ch->proto == 1) {
    // channel-default compress_type and (until proven) the credential
    // ride every frame of the pump — the template is fixed, and a
    // pipelined first burst legitimately carries the credential on each
    // frame (the reference's FightAuthentication lets first-writers race)
    const uint32_t compress = ch->req_compress;
    const bool stamp_auth =
        !ch->auth_data.empty() &&
        !ch->auth_proven.load(std::memory_order_relaxed);
    const size_t auth_len = stamp_auth ? ch->auth_data.size() : 0;
    size_t meta_total = 1 + varint_len(meta_len) + meta_len +
                        (compress ? 1 + varint_len(compress) : 0) + 1 + 10 +
                        (auth_len ? 1 + varint_len(auth_len) + auth_len : 0);
    tmpl.resize(kPrpcHeader + meta_total + payload_len);
    uint8_t* t = reinterpret_cast<uint8_t*>(tmpl.data());
    memcpy(t, "PRPC", 4);
    put_be32(t + 4, static_cast<uint32_t>(meta_total + payload_len));
    put_be32(t + 8, static_cast<uint32_t>(meta_total));
    size_t o = kPrpcHeader;
    t[o++] = 0x0A;  // RpcMeta.request wrapping the caller's submessage
    o += put_varint(t + o, meta_len);
    if (meta_len) memcpy(t + o, meta, meta_len);
    o += meta_len;
    if (compress) {
      t[o++] = 0x18;  // compress_type (field 3)
      o += put_varint(t + o, compress);
    }
    t[o++] = 0x20;  // correlation_id
    cid_off = o;
    o += 10;  // patched per request
    if (auth_len) {
      t[o++] = 0x3A;  // authentication_data (field 7)
      o += put_varint(t + o, auth_len);
      memcpy(t + o, ch->auth_data.data(), auth_len);
      o += auth_len;
    }
    if (payload_len) memcpy(t + o, payload, payload_len);
  } else {
    // (tbus template below; the traced PRPC template is built after it)
    tmpl.resize(32 + meta_len + payload_len);
    uint32_t h[8];
    h[0] = kMagic;
    h[1] = static_cast<uint32_t>(meta_len + payload_len);
    h[2] = meta_len ? kFlagHasMeta : 0;
    h[3] = 0;
    h[4] = 0;
    h[5] = static_cast<uint32_t>(meta_len);
    h[6] = tb_crc32c(0, meta, meta_len);
    h[7] = 0;
    memcpy(tmpl.data(), h, sizeof h);
    if (meta_len) memcpy(tmpl.data() + 32, meta, meta_len);
    if (payload_len) memcpy(tmpl.data() + 32 + meta_len, payload, payload_len);
  }
  // traced-frame template (tb_channel_set_trace): the caller's
  // RpcRequestMeta submessage grown with the Dapper fields — trace_id /
  // parent_span_id / log_id / sampled are run-constant minimal varints,
  // span_id is a padded 10-byte varint patched per traced frame
  // (span = base + sequence, so every traced request is its own span).
  // Built ONCE like the plain template; every trace_every'th frame uses
  // it, the rest the plain one — counter-scheduled exact rate with zero
  // per-frame re-encoding, which is what keeps a traced flood within a
  // hair of the bare pump (the prpc_traced_pump_ns bench gate).
  std::vector<char> ttmpl;
  size_t tcid_off = 0, tspan_off = 0;
  const uint32_t trace_every = ch->proto == 1 ? ch->trace_every : 0;
  if (trace_every != 0) {
    const uint32_t compress = ch->req_compress;
    const bool stamp_auth =
        !ch->auth_data.empty() &&
        !ch->auth_proven.load(std::memory_order_relaxed);
    const size_t auth_len = stamp_auth ? ch->auth_data.size() : 0;
    size_t sub_total =
        meta_len + (ch->tr_log_id ? 1 + varint_len(ch->tr_log_id) : 0) +
        (ch->tr_trace_id ? 1 + varint_len(ch->tr_trace_id) : 0) + 1 + 10 +
        (ch->tr_parent_span_id ? 1 + varint_len(ch->tr_parent_span_id)
                               : 0) +
        (ch->tr_sampled ? 2 : 0);
    size_t meta_total = 1 + varint_len(sub_total) + sub_total +
                        (compress ? 1 + varint_len(compress) : 0) + 1 + 10 +
                        (auth_len ? 1 + varint_len(auth_len) + auth_len : 0);
    ttmpl.resize(kPrpcHeader + meta_total + payload_len);
    uint8_t* t = reinterpret_cast<uint8_t*>(ttmpl.data());
    memcpy(t, "PRPC", 4);
    put_be32(t + 4, static_cast<uint32_t>(meta_total + payload_len));
    put_be32(t + 8, static_cast<uint32_t>(meta_total));
    size_t o = kPrpcHeader;
    t[o++] = 0x0A;  // RpcMeta.request wrapping the grown submessage
    o += put_varint(t + o, sub_total);
    if (meta_len) memcpy(t + o, meta, meta_len);
    o += meta_len;
    if (ch->tr_log_id) {
      t[o++] = 0x18;  // RpcRequestMeta.log_id (field 3)
      o += put_varint(t + o, ch->tr_log_id);
    }
    if (ch->tr_trace_id) {
      t[o++] = 0x20;  // RpcRequestMeta.trace_id (field 4)
      o += put_varint(t + o, ch->tr_trace_id);
    }
    t[o++] = 0x28;  // RpcRequestMeta.span_id (field 5)
    tspan_off = o;
    o += 10;  // patched per traced frame
    if (ch->tr_parent_span_id) {
      t[o++] = 0x30;  // RpcRequestMeta.parent_span_id (field 6)
      o += put_varint(t + o, ch->tr_parent_span_id);
    }
    if (ch->tr_sampled) {
      t[o++] = 0x48;  // RpcRequestMeta.traced_sampled (field 9, extension)
      t[o++] = 1;
    }
    if (compress) {
      t[o++] = 0x18;  // RpcMeta.compress_type (field 3)
      o += put_varint(t + o, compress);
    }
    t[o++] = 0x20;  // RpcMeta.correlation_id (field 4)
    tcid_off = o;
    o += 10;  // patched per request
    if (auth_len) {
      t[o++] = 0x3A;  // authentication_data (field 7)
      o += put_varint(t + o, auth_len);
      memcpy(t + o, ch->auth_data.data(), auth_len);
      o += auth_len;
    }
    if (payload_len) memcpy(t + o, payload, payload_len);
  }
  auto t0 = std::chrono::steady_clock::now();
  uint64_t trace_seq = 0;  // counter schedule: frame 0 is traced
  while (done < n && result == 0) {
    // fill the window: pack EVERY frame the window allows, then flush the
    // whole batch with as few writev calls as the kernel accepts (one
    // syscall per window refill, not per request)
    while (outstanding < inflight && sent < n) {
      uint64_t cid = channel_next_cid(ch);
      if (ch->proto == 1) {
        if (trace_every != 0 && trace_seq++ % trace_every == 0) {
          uint8_t* t = reinterpret_cast<uint8_t*>(ttmpl.data());
          put_varint_fixed10(t + tspan_off, ch->tr_span_id + trace_seq);
          put_varint_fixed10(t + tcid_off, cid);
          tb_iobuf_append(frame, ttmpl.data(), ttmpl.size());
          ++sent;
          ++outstanding;
          continue;
        }
        put_varint_fixed10(
            reinterpret_cast<uint8_t*>(tmpl.data()) + cid_off, cid);
      } else {
        uint32_t cid32[2] = {static_cast<uint32_t>(cid),
                             static_cast<uint32_t>(cid >> 32)};
        memcpy(tmpl.data() + cid_off, cid32, sizeof cid32);
      }
      tb_iobuf_append(frame, tmpl.data(), tmpl.size());
      ++sent;
      ++outstanding;
    }
    while (tb_iobuf_size(frame) > 0) {
      long rc = tb_iobuf_cut_into_fd(frame, ch->fd, 4u << 20);
      if (rc > 0) continue;
      if (rc == -EINTR) continue;
      if (rc == 0 || rc == -EAGAIN || rc == -EWOULDBLOCK) break;  // kernel full
      result = rc;  // hard write error
      break;
    }
    if (result != 0) break;
    // drain completions (and finish any partial write while waiting)
    pollfd pf{ch->fd, static_cast<short>(
                          POLLIN | (tb_iobuf_size(frame) > 0 ? POLLOUT : 0)),
              0};
    uint64_t now = now_ms();
    if (now >= deadline) {
      result = -ETIMEDOUT;
      break;
    }
    int prc = poll(&pf, 1, static_cast<int>(std::min<uint64_t>(deadline - now, 100)));
    if (prc < 0 && errno != EINTR) {
      result = -errno;
      break;
    }
    if (pf.revents & POLLOUT) {
      while (tb_iobuf_size(frame) > 0) {
        long rc = tb_iobuf_cut_into_fd(frame, ch->fd, 4u << 20);
        if (rc > 0) continue;
        if (rc == -EINTR) continue;
        if (rc == 0 || rc == -EAGAIN || rc == -EWOULDBLOCK) break;
        result = rc;
        break;
      }
    }
    if (pf.revents & POLLIN) {
      for (;;) {
        long rd = tb_iobuf_append_from_fd(ch->rbuf, ch->fd, burst);
        if (rd > 0) {
          if (static_cast<size_t>(rd) < burst) break;
          continue;
        }
        if (rd == -EAGAIN || rd == -EWOULDBLOCK) break;
        if (rd == -EINTR) continue;
        result = rd == 0 ? -EPIPE : rd;
        break;
      }
      while (result == 0) {
        if (ch->proto == 1) {
          uint32_t body_len = 0, pmeta_len = 0;
          int prc3 = prpc_peek(ch->rbuf, &body_len, &pmeta_len,
                               kClientMaxBody);
          if (prc3 == 1) break;
          char mscratch[4096];
          if (prc3 != 0 || pmeta_len > sizeof mscratch) {
            result = -EPROTO;
            break;
          }
          if (tb_iobuf_size(ch->rbuf) < kPrpcHeader + body_len) break;
          if (pmeta_len)
            tb_iobuf_copy_to(ch->rbuf, mscratch, pmeta_len, kPrpcHeader);
          tb_iobuf_popn(ch->rbuf, kPrpcHeader + body_len);
          PrpcMeta pm = scan_prpc_meta(mscratch, pmeta_len);
          if (!pm.ok) {
            result = -EPROTO;
          } else {
            bool mis = false;  // count wrong-shard tags; the pump's
            channel_check_cid(ch, pm.cid, &mis);  // completion count stands
            if (pm.error_code != 0) result = -EREMOTEIO;
            ++done;
            --outstanding;
          }
          continue;
        }
        tb_tbus_hdr hdr;
        int prc2 = tb_tbus_peek(ch->rbuf, &hdr);
        if (prc2 == 1) break;
        // the frame cap was missing here (fabricscan wire-bounds catch):
        // without it a hostile server claiming a ~4 GiB body_len makes
        // the "wait for the full frame" test below grow rbuf without
        // bound — the exact DoS pump_once's cap already closed
        if (prc2 == -1 || hdr.meta_len > hdr.body_len ||
            hdr.body_len > kClientMaxBody) {
          result = -EPROTO;
          break;
        }
        if (tb_iobuf_size(ch->rbuf) < kHeader + hdr.body_len) break;
        char mscratch[4096];
        if (hdr.meta_len > sizeof mscratch) {
          result = -EPROTO;
          break;
        }
        // one reusable body handle for the whole pump (clear per frame):
        // a create/destroy pair per response is pure overhead here
        if (ch->pump_body == nullptr) ch->pump_body = tb_iobuf_create();
        if (tb_tbus_cut(ch->rbuf, &hdr, hdr.meta_len ? mscratch : nullptr,
                        ch->pump_body) != 0)
          result = -EPROTO;
        tb_iobuf_clear(ch->pump_body);
        if (result == 0) {
          bool mis = false;
          channel_check_cid(
              ch,
              static_cast<uint64_t>(hdr.cid_lo) |
                  (static_cast<uint64_t>(hdr.cid_hi) << 32),
              &mis);
          if (hdr.error_code != 0) result = -EREMOTEIO;
          ++done;
          --outstanding;
        }
      }
    }
  }
  tb_iobuf_destroy(frame);
  if (result != 0) return result;
  ch->auth_proven.store(true, std::memory_order_relaxed);
  auto dt = std::chrono::duration_cast<std::chrono::nanoseconds>(
                std::chrono::steady_clock::now() - t0)
                .count();
  return static_cast<long>(dt / n);
}

// fabricscan: role(stop)
void tb_channel_destroy(tb_channel* ch) {
  channel_fail(ch, -ECANCELED);
  if (ch->fd >= 0) close(ch->fd);
  std::unique_lock<std::mutex> pl(ch->pmu);
  for (auto& kv : ch->pending) {
    Pending* p = kv.second;
    if (!p->targeted) {
      if (p->body != nullptr) tb_iobuf_destroy(p->body);
      delete p;
    }
  }
  ch->pending.clear();
  ch->doneq.clear();
  pl.unlock();
  tb_iobuf_destroy(ch->rbuf);
  if (ch->pump_body != nullptr) tb_iobuf_destroy(ch->pump_body);
  delete ch;
}

// ---------------------------------------------------------------------------
// codec C surface (tb_codec_*): the server's codec table exported so the
// Python seam (protocol/compress.py) runs the SAME implementation — the
// client-side compress before a native call, and the Python route's
// decompress, stop paying interpreter-speed codec loops while staying
// byte-identical to the plane by construction.
// ---------------------------------------------------------------------------

long tb_codec_compress(int codec, const void* in, size_t in_len,
                       tb_iobuf* out) {
  static thread_local ZCtx ctx;  // callers are arbitrary Python threads
  int rc = codec_compress(ctx, static_cast<uint32_t>(codec),
                          static_cast<const uint8_t*>(in), in_len, ctx.cbuf);
  if (rc != 0) return rc == -3 ? -3 : -1;
  if (!ctx.cbuf.empty()) tb_iobuf_append(out, ctx.cbuf.data(),
                                         ctx.cbuf.size());
  return static_cast<long>(ctx.cbuf.size());
}

long tb_codec_decompress(int codec, const void* in, size_t in_len,
                         size_t max_out, tb_iobuf* out) {
  static thread_local ZCtx ctx;
  size_t ceil = max_out != 0 ? max_out : static_cast<size_t>(-1);
  int rc = codec_decompress(ctx, static_cast<uint32_t>(codec),
                            static_cast<const uint8_t*>(in), in_len, ceil,
                            ctx.dbuf);
  if (rc != 0) return rc;
  if (!ctx.dbuf.empty()) tb_iobuf_append(out, ctx.dbuf.data(),
                                         ctx.dbuf.size());
  return static_cast<long>(ctx.dbuf.size());
}

// ---------------------------------------------------------------------------
// RpcMeta scanner C surface (tb_scan_prpc_meta): the scanner the server
// cut path and the client pump run, exported so the differential
// wire-decoder fuzz (tests/test_wire_differential.py) can feed identical
// meta bytes to this and to protocol/baidu_std.py's decoder and assert
// the twins agree on accept/reject and on every decoded field.
// ---------------------------------------------------------------------------

long tb_scan_prpc_meta(const void* meta, size_t meta_len,
                       uint64_t* cid_out, long* attachment_out,
                       long* timeout_ms_out, uint32_t* compress_out,
                       uint32_t* error_code_out,
                       char* svc_out, size_t svc_cap, size_t* svc_len_out,
                       char* mth_out, size_t mth_cap, size_t* mth_len_out,
                       uint64_t* log_id_out, uint64_t* trace_id_out,
                       uint64_t* span_id_out, uint64_t* parent_span_id_out,
                       uint32_t* sampled_out) {
  PrpcMeta pm = scan_prpc_meta(static_cast<const char*>(meta), meta_len);
  if (!pm.ok) return -1;  // the connection-kill reject verdict
  if (pm.svc_len > svc_cap || pm.mth_len > mth_cap) return -2;
  *cid_out = pm.cid;
  *attachment_out = pm.attachment;
  *timeout_ms_out = pm.timeout_ms;
  *compress_out = pm.compress;
  *error_code_out = pm.error_code;
  if (pm.svc_len != 0) memcpy(svc_out, pm.svc, pm.svc_len);
  *svc_len_out = pm.svc_len;
  if (pm.mth_len != 0) memcpy(mth_out, pm.mth, pm.mth_len);
  *mth_len_out = pm.mth_len;
  *log_id_out = pm.log_id;
  *trace_id_out = pm.trace_id;
  *span_id_out = pm.span_id;
  *parent_span_id_out = pm.parent_span_id;
  *sampled_out = pm.sampled;
  return (pm.to_python ? 1 : 0) | (pm.is_response ? 2 : 0);
}

// ---------------------------------------------------------------------------
// work-stealing deque C surface (tb_wsq_*): the dispatch pool's Chase–Lev
// deque exported standalone — the TSAN steal-storm stress drives it from
// Python, and future native schedulers can reuse it.
// ---------------------------------------------------------------------------

struct tb_wsq {
  explicit tb_wsq(size_t cap) : d(cap) {}
  WorkDeque d;
};

tb_wsq* tb_wsq_create(size_t capacity) { return new tb_wsq(capacity); }

void tb_wsq_destroy(tb_wsq* q) { delete q; }

int tb_wsq_push(tb_wsq* q, uint64_t value) {
  return q->d.push(value) ? 0 : -1;
}

int tb_wsq_pop(tb_wsq* q, uint64_t* out) { return q->d.pop(out) ? 1 : 0; }

int tb_wsq_steal(tb_wsq* q, uint64_t* out) {
  return q->d.steal(out) ? 1 : 0;
}

long tb_wsq_size(const tb_wsq* q) { return q->d.size(); }
