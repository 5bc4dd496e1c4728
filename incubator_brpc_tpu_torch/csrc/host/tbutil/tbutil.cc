// tbutil implementation — see tbutil.h for the design contract and the
// reference counterparts each piece mirrors.
#include "tbutil.h"

#include <errno.h>
#include <string.h>
#include <sys/time.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>
#include <zlib.h>

#include <atomic>
#include <cstdlib>
#include <deque>
#include <list>
#include <mutex>
#include <new>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Blocks
// ---------------------------------------------------------------------------

enum BlockSource : uint8_t {
  SRC_POOL = 0,      // header+data in one allocation, cached in the pool
  SRC_MALLOC = 1,    // same layout but non-default cap: freed, not cached
  SRC_EXTERNAL = 2,  // data owned by caller; release_cb on last unref
  SRC_REGION = 3,    // data carved from a registered region slab
};

struct Block {
  std::atomic<uint32_t> nshared;
  std::atomic<uint32_t> size;  // high-water write offset into data
  uint32_t cap;
  uint8_t source;
  int region_id;
  char* data;
  tb_release_fn release_cb;
  void* release_ctx;
  Block* next;  // freelist link
};

std::atomic<size_t> g_default_block_size{8192};
std::atomic<size_t> g_blocks_live{0};

// Global overflow cache behind the TLS caches.
struct GlobalBlockCache {
  std::mutex mu;
  Block* head = nullptr;
  size_t count = 0;
  static constexpr size_t kMax = 1024;
};
GlobalBlockCache g_block_cache;

// Per-thread cache (reference keeps <=8 blocks/thread, iobuf.cpp:355-430).
struct TlsBlockCache {
  // sized to one full readv burst so the read loop recycles blocks
  // through the TLS cache instead of malloc (reference keeps 8/thread;
  // our reader frees a whole burst at once after the cut)
  static constexpr size_t kMax = 64;
  Block* head = nullptr;
  size_t count = 0;
  ~TlsBlockCache();
};

void free_block_memory(Block* b) {
  g_blocks_live.fetch_sub(1, std::memory_order_relaxed);
  ::free(b);
}

TlsBlockCache::~TlsBlockCache() {
  // Thread exit: hand cached blocks to the global cache (or free).
  std::lock_guard<std::mutex> lk(g_block_cache.mu);
  while (head) {
    Block* b = head;
    head = b->next;
    if (g_block_cache.count < GlobalBlockCache::kMax) {
      b->next = g_block_cache.head;
      g_block_cache.head = b;
      ++g_block_cache.count;
    } else {
      free_block_memory(b);
    }
  }
  count = 0;
}

thread_local TlsBlockCache tls_block_cache;

Block* alloc_block_raw(size_t cap) {
  Block* b = static_cast<Block*>(::malloc(sizeof(Block) + cap));
  if (!b) return nullptr;
  g_blocks_live.fetch_add(1, std::memory_order_relaxed);
  b->nshared.store(1, std::memory_order_relaxed);
  b->size.store(0, std::memory_order_relaxed);
  b->cap = static_cast<uint32_t>(cap);
  b->source = cap == g_default_block_size.load(std::memory_order_relaxed)
                  ? SRC_POOL
                  : SRC_MALLOC;
  b->region_id = -1;
  b->data = reinterpret_cast<char*>(b + 1);
  b->release_cb = nullptr;
  b->release_ctx = nullptr;
  b->next = nullptr;
  return b;
}

Block* get_block() {
  const size_t def = g_default_block_size.load(std::memory_order_relaxed);
  TlsBlockCache& tls = tls_block_cache;
  while (tls.head) {
    Block* b = tls.head;
    tls.head = b->next;
    --tls.count;
    if (b->cap == def) {
      b->nshared.store(1, std::memory_order_relaxed);
      b->size.store(0, std::memory_order_relaxed);
      b->next = nullptr;
      return b;
    }
    free_block_memory(b);  // stale size after tb_set_block_size
  }
  {
    std::lock_guard<std::mutex> lk(g_block_cache.mu);
    while (g_block_cache.head) {
      Block* b = g_block_cache.head;
      g_block_cache.head = b->next;
      --g_block_cache.count;
      if (b->cap == def) {
        b->nshared.store(1, std::memory_order_relaxed);
        b->size.store(0, std::memory_order_relaxed);
        b->next = nullptr;
        return b;
      }
      free_block_memory(b);
    }
  }
  return alloc_block_raw(def);
}

// ---- regions ----

struct Region {
  char* base = nullptr;
  size_t block_bytes = 0;
  std::mutex mu;
  std::vector<char*> freelist;
};
std::mutex g_regions_mu;
std::deque<Region>* g_regions = nullptr;  // leaked on purpose (never-free)

void region_return(int rid, char* data) {
  std::lock_guard<std::mutex> lk(g_regions_mu);
  Region& r = (*g_regions)[static_cast<size_t>(rid)];
  std::lock_guard<std::mutex> lk2(r.mu);
  r.freelist.push_back(data);
}

void dec_ref(Block* b) {
  if (b->nshared.fetch_sub(1, std::memory_order_acq_rel) != 1) return;
  switch (b->source) {
    case SRC_EXTERNAL: {
      // Last ref dropped: fire the owner's release callback on this thread.
      // Contract (reference iobuf.cpp:258-306): cb must be cheap/non-
      // blocking — it may run on a transport completion path.
      if (b->release_cb) b->release_cb(b->data, b->release_ctx);
      g_blocks_live.fetch_sub(1, std::memory_order_relaxed);
      ::free(b);
      return;
    }
    case SRC_REGION: {
      region_return(b->region_id, b->data);
      g_blocks_live.fetch_sub(1, std::memory_order_relaxed);
      ::free(b);
      return;
    }
    case SRC_MALLOC:
      free_block_memory(b);
      return;
    case SRC_POOL:
    default: {
      TlsBlockCache& tls = tls_block_cache;
      if (tls.count < TlsBlockCache::kMax) {
        b->next = tls.head;
        tls.head = b;
        ++tls.count;
        return;
      }
      std::lock_guard<std::mutex> lk(g_block_cache.mu);
      if (g_block_cache.count < GlobalBlockCache::kMax) {
        b->next = g_block_cache.head;
        g_block_cache.head = b;
        ++g_block_cache.count;
        return;
      }
      free_block_memory(b);
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// IOBuf
// ---------------------------------------------------------------------------

struct BlockRef {
  Block* block;
  uint32_t offset;
  uint32_t length;
};

}  // namespace

struct tb_iobuf {
  std::deque<BlockRef> refs;
  size_t nbytes = 0;
};

namespace {

// Try to extend the tail ref in place. Safe under sharing: extension is a
// CAS claiming [expected, expected+m) of the block, so two IOBufs sharing
// the tail block can never hand out the same bytes twice.
size_t append_into_tail(tb_iobuf* b, const char* data, size_t n) {
  if (b->refs.empty()) return 0;
  BlockRef& r = b->refs.back();
  Block* blk = r.block;
  if (blk->source == SRC_EXTERNAL) return 0;
  uint32_t expected = r.offset + r.length;
  if (expected >= blk->cap) return 0;
  uint32_t m = static_cast<uint32_t>(
      n < static_cast<size_t>(blk->cap - expected) ? n : blk->cap - expected);
  uint32_t cur = expected;
  if (!blk->size.compare_exchange_strong(cur, expected + m,
                                         std::memory_order_acq_rel)) {
    return 0;  // someone else extended past our view; take a fresh block
  }
  memcpy(blk->data + expected, data, m);
  r.length += m;
  b->nbytes += m;
  return m;
}

void push_ref_shared(tb_iobuf* b, const BlockRef& r) {
  r.block->nshared.fetch_add(1, std::memory_order_relaxed);
  b->refs.push_back(r);
  b->nbytes += r.length;
}

}  // namespace

extern "C" {

void tb_set_block_size(size_t bytes) {
  if (bytes < 64) bytes = 64;
  g_default_block_size.store(bytes, std::memory_order_relaxed);
}

size_t tb_block_size(void) {
  return g_default_block_size.load(std::memory_order_relaxed);
}

void tb_block_pool_stats(size_t* live, size_t* cached) {
  if (live) *live = g_blocks_live.load(std::memory_order_relaxed);
  if (cached) {
    size_t c = tls_block_cache.count;
    std::lock_guard<std::mutex> lk(g_block_cache.mu);
    *cached = c + g_block_cache.count;
  }
}

// IOBuf handles churn once per frame on the hot path: they come from the
// never-freeing ObjectPool (placement-new over pooled slots) instead of
// malloc/free — the reference backs its hottest fixed-size objects with
// the same pool (object_pool.h; butex objects, TaskMeta).
static tb_objpool* iobuf_handle_pool() {
  static tb_objpool* pool = tb_objpool_create(sizeof(tb_iobuf));
  return pool;
}

tb_iobuf* tb_iobuf_create(void) {
  void* mem = tb_objpool_get(iobuf_handle_pool());
  if (!mem) return nullptr;
  return new (mem) tb_iobuf();
}

void tb_iobuf_clear(tb_iobuf* b) {
  for (BlockRef& r : b->refs) dec_ref(r.block);
  b->refs.clear();
  b->nbytes = 0;
}

void tb_iobuf_destroy(tb_iobuf* b) {
  if (!b) return;
  tb_iobuf_clear(b);
  b->~tb_iobuf();
  tb_objpool_return(iobuf_handle_pool(), b);
}

void tb_iobuf_handle_pool_stats(size_t* live, size_t* free_count) {
  if (live) *live = tb_objpool_live(iobuf_handle_pool());
  if (free_count) *free_count = tb_objpool_free_count(iobuf_handle_pool());
}

size_t tb_iobuf_size(const tb_iobuf* b) { return b->nbytes; }

size_t tb_iobuf_block_count(const tb_iobuf* b) { return b->refs.size(); }

void tb_iobuf_append(tb_iobuf* b, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  size_t done = append_into_tail(b, p, n);
  p += done;
  n -= done;
  while (n > 0) {
    Block* blk = get_block();
    uint32_t m = static_cast<uint32_t>(n < blk->cap ? n : blk->cap);
    memcpy(blk->data, p, m);
    blk->size.store(m, std::memory_order_release);
    b->refs.push_back(BlockRef{blk, 0, m});
    b->nbytes += m;
    p += m;
    n -= m;
  }
}

namespace {

// Shared-release shim for external buffers that exceed one Block's 32-bit
// length field: each chunk-block decrements; the last one fires the user
// callback exactly once.
struct SharedExternal {
  std::atomic<uint32_t> pending;
  char* base;
  tb_release_fn cb;
  void* ctx;
};

void shared_external_release(void* data, void* shim_ptr) {
  (void)data;
  SharedExternal* s = static_cast<SharedExternal*>(shim_ptr);
  if (s->pending.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    if (s->cb) s->cb(s->base, s->ctx);
    delete s;
  }
}

}  // namespace

void tb_iobuf_append_external(tb_iobuf* b, void* data, size_t n,
                              tb_release_fn cb, void* ctx) {
  // BlockRef lengths are 32-bit; chunk huge buffers across several
  // external blocks sharing one release shim so the callback still fires
  // exactly once, after the last chunk's last ref drops.
  constexpr size_t kMaxChunk = 0xC0000000u;  // 3 GiB, well under UINT32_MAX
  const size_t nchunks = n == 0 ? 1 : (n + kMaxChunk - 1) / kMaxChunk;
  SharedExternal* shim = nullptr;
  if (nchunks > 1) {
    shim = new SharedExternal{
        {static_cast<uint32_t>(nchunks)}, static_cast<char*>(data), cb, ctx};
  }
  char* p = static_cast<char*>(data);
  size_t left = n;
  for (size_t i = 0; i < nchunks; ++i) {
    const size_t m = left < kMaxChunk ? left : kMaxChunk;
    Block* blk = static_cast<Block*>(::malloc(sizeof(Block)));
    g_blocks_live.fetch_add(1, std::memory_order_relaxed);
    blk->nshared.store(1, std::memory_order_relaxed);
    blk->size.store(static_cast<uint32_t>(m), std::memory_order_relaxed);
    blk->cap = static_cast<uint32_t>(m);
    blk->source = SRC_EXTERNAL;
    blk->region_id = -1;
    blk->data = p;
    if (shim) {
      blk->release_cb = shared_external_release;
      blk->release_ctx = shim;
    } else {
      blk->release_cb = cb;
      blk->release_ctx = ctx;
    }
    blk->next = nullptr;
    b->refs.push_back(BlockRef{blk, 0, static_cast<uint32_t>(m)});
    b->nbytes += m;
    p += m;
    left -= m;
  }
}

void tb_iobuf_append_iobuf(tb_iobuf* to, const tb_iobuf* from) {
  for (const BlockRef& r : from->refs) push_ref_shared(to, r);
}

size_t tb_iobuf_cutn(tb_iobuf* from, tb_iobuf* to, size_t n) {
  size_t moved = 0;
  while (n > 0 && !from->refs.empty()) {
    BlockRef& r = from->refs.front();
    if (r.length <= n) {
      to->refs.push_back(r);  // ref moves wholesale; refcount unchanged
      to->nbytes += r.length;
      from->nbytes -= r.length;
      n -= r.length;
      moved += r.length;
      from->refs.pop_front();
    } else {
      BlockRef part{r.block, r.offset, static_cast<uint32_t>(n)};
      push_ref_shared(to, part);
      r.offset += static_cast<uint32_t>(n);
      r.length -= static_cast<uint32_t>(n);
      from->nbytes -= n;
      moved += n;
      n = 0;
    }
  }
  return moved;
}

size_t tb_iobuf_popn(tb_iobuf* from, size_t n) {
  size_t popped = 0;
  while (n > 0 && !from->refs.empty()) {
    BlockRef& r = from->refs.front();
    if (r.length <= n) {
      n -= r.length;
      popped += r.length;
      from->nbytes -= r.length;
      dec_ref(r.block);
      from->refs.pop_front();
    } else {
      r.offset += static_cast<uint32_t>(n);
      r.length -= static_cast<uint32_t>(n);
      from->nbytes -= n;
      popped += n;
      n = 0;
    }
  }
  return popped;
}

size_t tb_iobuf_copy_to(const tb_iobuf* b, void* out, size_t n, size_t pos) {
  char* dst = static_cast<char*>(out);
  size_t copied = 0;
  for (const BlockRef& r : b->refs) {
    if (n == 0) break;
    if (pos >= r.length) {
      pos -= r.length;
      continue;
    }
    size_t avail = r.length - pos;
    size_t m = n < avail ? n : avail;
    memcpy(dst + copied, r.block->data + r.offset + pos, m);
    copied += m;
    n -= m;
    pos = 0;
  }
  return copied;
}

int tb_iobuf_refs(const tb_iobuf* b, tb_ref_view* out, int max) {
  int i = 0;
  for (const BlockRef& r : b->refs) {
    if (i >= max) break;
    out[i].data = r.block->data + r.offset;
    out[i].length = r.length;
    ++i;
  }
  return i;
}

int tb_iobuf_block_shared_count(const tb_iobuf* b, size_t i) {
  if (i >= b->refs.size()) return -1;
  return static_cast<int>(
      b->refs[i].block->nshared.load(std::memory_order_relaxed));
}

long tb_iobuf_cut_into_fd(tb_iobuf* b, int fd, size_t max_bytes) {
  // Continuation loop over the 256-iovec writev ceiling: a multi-MB
  // backlog of small blocks (256 × 8 KB = 2 MB per writev) keeps writing
  // until max_bytes, a short write (kernel buffer full), or an error —
  // callers see ONE call drain what the kernel will take instead of
  // bouncing through the ctypes boundary once per 2 MB.
  constexpr int kMaxIov = 256;
  struct iovec iov[kMaxIov];
  long written_total = 0;
  while (static_cast<size_t>(written_total) < max_bytes) {
    int niov = 0;
    size_t total = 0;
    size_t budget = max_bytes - static_cast<size_t>(written_total);
    for (const BlockRef& r : b->refs) {
      if (niov >= kMaxIov || total >= budget) break;
      size_t len = r.length;
      if (total + len > budget) len = budget - total;
      iov[niov].iov_base = r.block->data + r.offset;
      iov[niov].iov_len = len;
      total += len;
      ++niov;
    }
    if (niov == 0) break;
    ssize_t nw = ::writev(fd, iov, niov);
    if (nw < 0) {
      if (errno == EINTR) continue;
      return written_total > 0 ? written_total : -errno;
    }
    tb_iobuf_popn(b, static_cast<size_t>(nw));
    written_total += nw;
    if (static_cast<size_t>(nw) < total) break;  // short write: kernel full
  }
  return written_total;
}

// iovec budget per readv: 64 default blocks = 512KB/burst — the bytes-
// per-event ceiling of the reader loop (the reference's IOPortal reads
// with a comparable budget; 8 iovecs capped loopback at ~64KB/event)
constexpr int kReadIovBudget = 64;

size_t tb_iobuf_read_burst(void) {
  return kReadIovBudget * g_default_block_size.load(std::memory_order_relaxed);
}

long tb_iobuf_append_from_fd(tb_iobuf* b, int fd, size_t max_bytes) {
  constexpr int kMaxIov = kReadIovBudget;
  Block* blocks[kMaxIov];
  struct iovec iov[kMaxIov];
  int niov = 0;
  size_t total = 0;
  while (niov < kMaxIov && total < max_bytes) {
    Block* blk = get_block();
    blocks[niov] = blk;
    size_t want = max_bytes - total;
    size_t len = want < blk->cap ? want : blk->cap;
    iov[niov].iov_base = blk->data;
    iov[niov].iov_len = len;
    total += len;
    ++niov;
  }
  ssize_t nr = ::readv(fd, iov, niov);
  if (nr < 0) {
    int err = errno;
    for (int i = 0; i < niov; ++i) dec_ref(blocks[i]);
    return -err;
  }
  size_t left = static_cast<size_t>(nr);
  for (int i = 0; i < niov; ++i) {
    if (left == 0) {
      dec_ref(blocks[i]);
      continue;
    }
    uint32_t used = static_cast<uint32_t>(
        left < iov[i].iov_len ? left : iov[i].iov_len);
    blocks[i]->size.store(used, std::memory_order_release);
    b->refs.push_back(BlockRef{blocks[i], 0, used});
    b->nbytes += used;
    left -= used;
  }
  return nr;
}

// Bulk variant for long streaming drains: same readv shape, but blocks of
// ``block_bytes`` (SRC_MALLOC — freed, not pooled) instead of the pooled
// default. 64 x 8 KB pooled blocks cap a burst at 512 KB and cost a
// refcount+freelist round trip per 8 KB; a saturated byte stream reads
// multi-MB bursts into a handful of big blocks instead (the reference's
// IOPortal grows its read budget the same way when a socket keeps
// delivering full reads, input_messenger read loop).
long tb_iobuf_append_from_fd_bulk(tb_iobuf* b, int fd, size_t max_bytes,
                                  size_t block_bytes) {
  const size_t def = g_default_block_size.load(std::memory_order_relaxed);
  if (block_bytes <= def) return tb_iobuf_append_from_fd(b, fd, max_bytes);
  constexpr int kMaxIov = 32;
  Block* blocks[kMaxIov];
  struct iovec iov[kMaxIov];
  int niov = 0;
  size_t total = 0;
  while (niov < kMaxIov && total < max_bytes) {
    size_t want = max_bytes - total;
    size_t cap = want < block_bytes ? want : block_bytes;
    Block* blk = alloc_block_raw(cap);
    if (blk == nullptr) break;
    blocks[niov] = blk;
    iov[niov].iov_base = blk->data;
    iov[niov].iov_len = cap;
    total += cap;
    ++niov;
  }
  if (niov == 0) return -ENOMEM;
  ssize_t nr = ::readv(fd, iov, niov);
  if (nr < 0) {
    int err = errno;
    for (int i = 0; i < niov; ++i) dec_ref(blocks[i]);
    return -err;
  }
  size_t left = static_cast<size_t>(nr);
  for (int i = 0; i < niov; ++i) {
    if (left == 0) {
      dec_ref(blocks[i]);
      continue;
    }
    uint32_t used = static_cast<uint32_t>(
        left < iov[i].iov_len ? left : iov[i].iov_len);
    blocks[i]->size.store(used, std::memory_order_release);
    b->refs.push_back(BlockRef{blocks[i], 0, used});
    b->nbytes += used;
    left -= used;
  }
  return nr;
}

// ---- regions ----

int tb_region_register(void* base, size_t total, size_t block_bytes) {
  if (!base || block_bytes == 0 || total < block_bytes) return -1;
  std::lock_guard<std::mutex> lk(g_regions_mu);
  if (!g_regions) g_regions = new std::deque<Region>();
  g_regions->emplace_back();
  Region& r = g_regions->back();
  r.base = static_cast<char*>(base);
  r.block_bytes = block_bytes;
  for (size_t off = 0; off + block_bytes <= total; off += block_bytes) {
    r.freelist.push_back(r.base + off);
  }
  return static_cast<int>(g_regions->size() - 1);
}

int tb_iobuf_append_from_region(tb_iobuf* b, int rid, const void* data,
                                size_t n) {
  Region* reg;
  {
    std::lock_guard<std::mutex> lk(g_regions_mu);
    if (!g_regions || rid < 0 ||
        static_cast<size_t>(rid) >= g_regions->size()) {
      return -1;
    }
    reg = &(*g_regions)[static_cast<size_t>(rid)];
  }
  // Reserve every slab up front so exhaustion mid-copy cannot leave the
  // IOBuf half-mutated (failure must not consume blocks or append bytes).
  const size_t nblocks =
      n == 0 ? 0 : (n + reg->block_bytes - 1) / reg->block_bytes;
  std::vector<char*> slabs;
  {
    std::lock_guard<std::mutex> lk(reg->mu);
    if (reg->freelist.size() < nblocks) return -1;
    slabs.assign(reg->freelist.end() - nblocks, reg->freelist.end());
    reg->freelist.resize(reg->freelist.size() - nblocks);
  }
  const char* p = static_cast<const char*>(data);
  for (char* slab : slabs) {
    Block* blk = static_cast<Block*>(::malloc(sizeof(Block)));
    g_blocks_live.fetch_add(1, std::memory_order_relaxed);
    uint32_t m = static_cast<uint32_t>(
        n < reg->block_bytes ? n : reg->block_bytes);
    blk->nshared.store(1, std::memory_order_relaxed);
    blk->size.store(m, std::memory_order_relaxed);
    blk->cap = static_cast<uint32_t>(reg->block_bytes);
    blk->source = SRC_REGION;
    blk->region_id = rid;
    blk->data = slab;
    blk->release_cb = nullptr;
    blk->release_ctx = nullptr;
    blk->next = nullptr;
    memcpy(slab, p, m);
    b->refs.push_back(BlockRef{blk, 0, m});
    b->nbytes += m;
    p += m;
    n -= m;
  }
  return 0;
}

size_t tb_region_free_blocks(int rid) {
  std::lock_guard<std::mutex> lk(g_regions_mu);
  if (!g_regions || rid < 0 || static_cast<size_t>(rid) >= g_regions->size()) {
    return 0;
  }
  Region& r = (*g_regions)[static_cast<size_t>(rid)];
  std::lock_guard<std::mutex> lk2(r.mu);
  return r.freelist.size();
}

// ---- wire fast path ----

}  // extern "C"

namespace {

// CRC32C (Castagnoli, reflected poly 0x82F63B78). zlib-style chaining:
// internal state is ~crc so seed 0 composes across calls.
uint32_t g_crc32c_table[8][256];

void crc32c_init_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
    g_crc32c_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = g_crc32c_table[0][i];
    for (int s = 1; s < 8; ++s) {
      c = g_crc32c_table[0][c & 0xFF] ^ (c >> 8);
      g_crc32c_table[s][i] = c;
    }
  }
}

uint32_t crc32c_sw(uint32_t crc, const unsigned char* p, size_t n) {
  // slice-by-8
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    w ^= crc;
    crc = g_crc32c_table[7][w & 0xFF] ^ g_crc32c_table[6][(w >> 8) & 0xFF] ^
          g_crc32c_table[5][(w >> 16) & 0xFF] ^
          g_crc32c_table[4][(w >> 24) & 0xFF] ^
          g_crc32c_table[3][(w >> 32) & 0xFF] ^
          g_crc32c_table[2][(w >> 40) & 0xFF] ^
          g_crc32c_table[1][(w >> 48) & 0xFF] ^ g_crc32c_table[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_crc32c_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc32c_hw(uint32_t crc,
                                                     const unsigned char* p,
                                                     size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    c = __builtin_ia32_crc32di(c, w);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = __builtin_ia32_crc32qi(c32, *p++);
  return c32;
}
#endif

uint32_t (*pick_crc32c_impl())(uint32_t, const unsigned char*, size_t) {
  crc32c_init_table();
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sse4.2")) return crc32c_hw;
#endif
  return crc32c_sw;
}

// resolved once at load time (before any Python thread exists)
uint32_t (*const g_crc32c_impl)(uint32_t, const unsigned char*, size_t) =
    pick_crc32c_impl();

inline uint32_t crc32c_update(uint32_t state, const void* data, size_t n) {
  return g_crc32c_impl(state, static_cast<const unsigned char*>(data), n);
}

constexpr uint32_t kTbusMagic = 0x54505243u;  // "TPRC" little-endian

}  // namespace

extern "C" {

uint32_t tb_crc32c(uint32_t seed, const void* data, size_t n) {
  return ~crc32c_update(~seed, data, n);
}

uint32_t tb_iobuf_crc32c(const tb_iobuf* b, uint32_t seed, size_t pos,
                         size_t n) {
  uint32_t state = ~seed;
  for (const BlockRef& r : b->refs) {
    if (n == 0) break;
    if (pos >= r.length) {
      pos -= r.length;
      continue;
    }
    size_t avail = r.length - pos;
    size_t m = n < avail ? n : avail;
    state = crc32c_update(state, r.block->data + r.offset + pos, m);
    n -= m;
    pos = 0;
  }
  return ~state;
}

int tb_tbus_peek(const tb_iobuf* in, tb_tbus_hdr* out) {
  // Reject a foreign magic as soon as 4 bytes exist — a short frame of
  // another protocol must yield "not mine" (so the messenger tries other
  // parsers), never "incomplete" (which would wait forever).
  if (in->nbytes >= 4) {
    uint32_t magic;
    tb_iobuf_copy_to(in, &magic, 4, 0);
    if (magic != kTbusMagic) return -1;
  }
  if (in->nbytes < 32) return 1;
  uint32_t w[8];
  tb_iobuf_copy_to(in, w, 32, 0);
  if (w[0] != kTbusMagic) return -1;
  out->body_len = w[1];
  out->flags = w[2];
  out->cid_lo = w[3];
  out->cid_hi = w[4];
  out->meta_len = w[5];
  out->crc = w[6];
  out->error_code = w[7];
  return 0;
}

// flag bit 3: the frame's crc covers the whole body (meta+payload+
// attachment). Default frames cover META ONLY — the reference's baidu_std
// carries no body checksum at all (TCP already checksums segments;
// baidu_rpc_protocol.cpp:53-58's header is just sizes), so routing info is
// protected here and bulk bytes ride the transport's own integrity.
constexpr uint32_t kFlagBodyCrc = 8;

// Callers bound the header's claimed sizes BEFORE cutting: peek fills
// them raw off the wire, and this function trusts them to size the meta
// copy-out and the body cut.
// fabricscan: requires-bounded(arg2.body_len, arg2.meta_len)
int tb_tbus_cut(tb_iobuf* in, const tb_tbus_hdr* hdr, void* meta_out,
                tb_iobuf* body_out) {
  if (hdr->meta_len > hdr->body_len) return -3;
  const size_t total = 32 + static_cast<size_t>(hdr->body_len);
  if (in->nbytes < total) return 1;
  const size_t span =
      (hdr->flags & kFlagBodyCrc) ? hdr->body_len : hdr->meta_len;
  if (tb_iobuf_crc32c(in, 0, 32, span) != hdr->crc) return -2;
  tb_iobuf_popn(in, 32);
  if (hdr->meta_len) {
    tb_iobuf_copy_to(in, meta_out, hdr->meta_len, 0);
    tb_iobuf_popn(in, hdr->meta_len);
  }
  tb_iobuf_cutn(in, body_out, hdr->body_len - hdr->meta_len);
  return 0;
}

void tb_tbus_pack(tb_iobuf* out, const void* meta, size_t meta_len,
                  const void* payload, size_t payload_len, const void* att,
                  size_t att_len, uint32_t cid_lo, uint32_t cid_hi,
                  uint32_t flags, uint32_t error_code, int copy_body) {
  uint32_t state = ~0u;
  if (meta_len) state = crc32c_update(state, meta, meta_len);
  if (flags & kFlagBodyCrc) {
    if (payload_len) state = crc32c_update(state, payload, payload_len);
    if (att_len) state = crc32c_update(state, att, att_len);
  }
  uint32_t hdr[8] = {kTbusMagic,
                     static_cast<uint32_t>(meta_len + payload_len + att_len),
                     flags,
                     cid_lo,
                     cid_hi,
                     static_cast<uint32_t>(meta_len),
                     ~state,
                     error_code};
  tb_iobuf_append(out, hdr, sizeof(hdr));
  if (meta_len) tb_iobuf_append(out, meta, meta_len);
  if (copy_body) {
    if (payload_len) tb_iobuf_append(out, payload, payload_len);
    if (att_len) tb_iobuf_append(out, att, att_len);
  }
}

// ---- misc ----

uint32_t tb_crc32(uint32_t seed, const void* data, size_t n) {
  return static_cast<uint32_t>(
      ::crc32(seed, static_cast<const Bytef*>(data),
              static_cast<uInt>(n)));
}

uint64_t tb_fast_rand(void) {
  // xorshift128+ per thread (reference fast_rand.cpp uses the same family).
  thread_local uint64_t s0 = 0, s1 = 0;
  if (s0 == 0 && s1 == 0) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    s0 = static_cast<uint64_t>(ts.tv_nsec) ^
         (reinterpret_cast<uintptr_t>(&s0) << 16);
    s1 = static_cast<uint64_t>(ts.tv_sec) * 1000000007ULL ^ 0x9E3779B97F4A7C15ULL;
    if (s0 == 0 && s1 == 0) s1 = 1;
  }
  uint64_t x = s0;
  const uint64_t y = s1;
  s0 = y;
  x ^= x << 23;
  s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  return s1 + y;
}

uint64_t tb_fast_rand_less_than(uint64_t bound) {
  if (bound == 0) return 0;
  return tb_fast_rand() % bound;
}

uint64_t tb_monotonic_ns(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ULL +
         static_cast<uint64_t>(ts.tv_nsec);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ResourcePool — versioned-id slab, never frees memory (ABA-safe).
// Versions are odd while live, even while free; id = version<<32 | slot.
// ---------------------------------------------------------------------------

struct tb_respool {
  size_t item_size;
  std::mutex mu;
  std::vector<char*> chunks;          // each chunk holds kChunkItems items
  std::vector<uint32_t> versions;     // per slot
  std::vector<uint32_t> free_slots;
  size_t nslots = 0;
  size_t live = 0;
  static constexpr size_t kChunkItems = 256;
};

extern "C" {

tb_respool* tb_respool_create(size_t item_size) {
  tb_respool* p = new tb_respool();
  p->item_size = item_size ? item_size : 1;
  return p;
}

void tb_respool_destroy(tb_respool* p) {
  if (!p) return;
  for (char* c : p->chunks) ::free(c);
  delete p;
}

static void* respool_slot_ptr(tb_respool* p, uint32_t slot) {
  return p->chunks[slot / tb_respool::kChunkItems] +
         (slot % tb_respool::kChunkItems) * p->item_size;
}

void* tb_respool_get(tb_respool* p, uint64_t* out_id) {
  std::lock_guard<std::mutex> lk(p->mu);
  uint32_t slot;
  if (!p->free_slots.empty()) {
    slot = p->free_slots.back();
    p->free_slots.pop_back();
    p->versions[slot] += 1;  // even -> odd: live again, old ids stale
  } else {
    if (p->nslots % tb_respool::kChunkItems == 0) {
      char* chunk = static_cast<char*>(
          ::calloc(tb_respool::kChunkItems, p->item_size));
      if (!chunk) return nullptr;
      p->chunks.push_back(chunk);
    }
    slot = static_cast<uint32_t>(p->nslots++);
    p->versions.push_back(1);
  }
  ++p->live;
  if (out_id) {
    *out_id = (static_cast<uint64_t>(p->versions[slot]) << 32) | slot;
  }
  return respool_slot_ptr(p, slot);
}

void* tb_respool_address(tb_respool* p, uint64_t id) {
  const uint32_t slot = static_cast<uint32_t>(id & 0xFFFFFFFFu);
  const uint32_t version = static_cast<uint32_t>(id >> 32);
  std::lock_guard<std::mutex> lk(p->mu);
  if (slot >= p->nslots) return nullptr;
  if (p->versions[slot] != version || (version & 1) == 0) return nullptr;
  return respool_slot_ptr(p, slot);
}

int tb_respool_return(tb_respool* p, uint64_t id) {
  const uint32_t slot = static_cast<uint32_t>(id & 0xFFFFFFFFu);
  const uint32_t version = static_cast<uint32_t>(id >> 32);
  std::lock_guard<std::mutex> lk(p->mu);
  if (slot >= p->nslots) return -1;
  if (p->versions[slot] != version || (version & 1) == 0) return -1;
  p->versions[slot] += 1;  // odd -> even: dead
  p->free_slots.push_back(slot);
  --p->live;
  return 0;
}

size_t tb_respool_live(const tb_respool* p) {
  tb_respool* q = const_cast<tb_respool*>(p);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->live;
}

// ---------------------------------------------------------------------------
// ObjectPool (reference src/butil/object_pool.h: pointer-addressed slab,
// free list, memory never returned to the OS so a stale pointer is at worst
// a recycled object, never a wild read)
// ---------------------------------------------------------------------------

struct tb_objpool {
  static constexpr size_t kChunkItems = 256;
  std::mutex mu;
  size_t item_size = 0;
  std::vector<char*> chunks;
  std::vector<void*> free_list;
  size_t nitems = 0;  // slots ever carved
  size_t live = 0;
};

tb_objpool* tb_objpool_create(size_t item_size) {
  tb_objpool* p = new tb_objpool();
  p->item_size = item_size < 8 ? 8 : item_size;
  return p;
}

void tb_objpool_destroy(tb_objpool* p) {
  if (!p) return;
  for (char* c : p->chunks) ::free(c);
  delete p;
}

void* tb_objpool_get(tb_objpool* p) {
  std::lock_guard<std::mutex> lk(p->mu);
  void* item;
  if (!p->free_list.empty()) {
    item = p->free_list.back();
    p->free_list.pop_back();
  } else {
    if (p->nitems % tb_objpool::kChunkItems == 0) {
      char* chunk =
          static_cast<char*>(::calloc(tb_objpool::kChunkItems, p->item_size));
      if (!chunk) return nullptr;
      p->chunks.push_back(chunk);
    }
    item = p->chunks.back() +
           (p->nitems % tb_objpool::kChunkItems) * p->item_size;
    ++p->nitems;
  }
  ++p->live;
  return item;
}

void tb_objpool_return(tb_objpool* p, void* item) {
  if (!item) return;
  std::lock_guard<std::mutex> lk(p->mu);
  p->free_list.push_back(item);
  --p->live;
}

size_t tb_objpool_live(const tb_objpool* p) {
  tb_objpool* q = const_cast<tb_objpool*>(p);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->live;
}

size_t tb_objpool_free_count(const tb_objpool* p) {
  tb_objpool* q = const_cast<tb_objpool*>(p);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->free_list.size();
}

// ---------------------------------------------------------------------------
// FlatMap (reference src/butil/containers/flat_map.h re-expressed as the
// typed u64->u64 open-addressing table hot paths need; linear probing,
// tombstones, grow at 70% occupancy)
// ---------------------------------------------------------------------------

struct tb_flatmap {
  enum : uint8_t { EMPTY = 0, FULL = 1, TOMB = 2 };
  // internally locked: ctypes drops the GIL per call, so Python threads
  // hit this concurrently (ObjectPool/ResourcePool get the same treatment)
  mutable std::mutex mu;
  std::vector<uint64_t> keys;
  std::vector<uint64_t> vals;
  std::vector<uint8_t> states;
  size_t nfull = 0;
  size_t noccupied = 0;  // FULL + TOMB (drives rehash)
};

static inline uint64_t fm_hash(uint64_t x) {
  // splitmix64 finalizer — cheap and well distributed
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

static size_t fm_round_up_pow2(size_t n) {
  // clamp: anything past 2^32 entries is a caller bug, and an unbounded
  // shift would overflow to 0 and spin forever
  const size_t kMaxCap = size_t(1) << 32;
  if (n > kMaxCap) n = kMaxCap;
  size_t c = 16;
  while (c < n) c <<= 1;
  return c;
}

static void fm_rehash(tb_flatmap* m, size_t new_cap);

static void fm_insert_nogrow(tb_flatmap* m, uint64_t key, uint64_t value) {
  const size_t mask = m->keys.size() - 1;
  size_t i = fm_hash(key) & mask;
  while (m->states[i] == tb_flatmap::FULL) i = (i + 1) & mask;
  if (m->states[i] == tb_flatmap::EMPTY) ++m->noccupied;
  m->states[i] = tb_flatmap::FULL;
  m->keys[i] = key;
  m->vals[i] = value;
  ++m->nfull;
}

static void fm_rehash(tb_flatmap* m, size_t new_cap) {
  std::vector<uint64_t> keys(new_cap), vals(new_cap);
  std::vector<uint8_t> states(new_cap, tb_flatmap::EMPTY);
  keys.swap(m->keys);
  vals.swap(m->vals);
  states.swap(m->states);
  const size_t old_full = m->nfull;
  m->nfull = 0;
  m->noccupied = 0;
  for (size_t i = 0; i < keys.size(); ++i) {
    if (states[i] == tb_flatmap::FULL) fm_insert_nogrow(m, keys[i], vals[i]);
  }
  (void)old_full;
}

tb_flatmap* tb_flatmap_create(size_t initial_capacity) {
  tb_flatmap* m = nullptr;
  try {
    m = new tb_flatmap();
    const size_t cap =
        fm_round_up_pow2(initial_capacity ? initial_capacity : 16);
    m->keys.assign(cap, 0);
    m->vals.assign(cap, 0);
    m->states.assign(cap, tb_flatmap::EMPTY);
    return m;
  } catch (const std::bad_alloc&) {
    delete m;
    return nullptr;  // never let the throw cross the C ABI into ctypes
  }
}

void tb_flatmap_destroy(tb_flatmap* m) { delete m; }

int tb_flatmap_insert(tb_flatmap* m, uint64_t key, uint64_t value) {
  std::lock_guard<std::mutex> lk(m->mu);
  const size_t mask = m->keys.size() - 1;
  size_t i = fm_hash(key) & mask;
  long first_tomb = -1;
  while (m->states[i] != tb_flatmap::EMPTY) {
    if (m->states[i] == tb_flatmap::FULL && m->keys[i] == key) {
      m->vals[i] = value;
      return 1;
    }
    if (m->states[i] == tb_flatmap::TOMB && first_tomb < 0) {
      first_tomb = static_cast<long>(i);
    }
    i = (i + 1) & mask;
  }
  // the scan already found the landing slot: reuse the first tombstone on
  // the chain, else the terminating EMPTY — no second probe
  if (first_tomb >= 0) {
    i = static_cast<size_t>(first_tomb);
  } else {
    ++m->noccupied;
  }
  m->states[i] = tb_flatmap::FULL;
  m->keys[i] = key;
  m->vals[i] = value;
  ++m->nfull;
  if (m->noccupied * 10 >= m->keys.size() * 7) {
    // size from live entries, not old capacity: tombstone churn rehashes
    // in place (clearing tombs) instead of growing without bound
    size_t want = fm_round_up_pow2(m->nfull * 4 < 16 ? 16 : m->nfull * 4);
    try {
      fm_rehash(m, want);
    } catch (const std::bad_alloc&) {
      return -1;  // documented OOM contract; never let the throw cross ctypes
    }
  }
  return 0;
}

int tb_flatmap_get(const tb_flatmap* m, uint64_t key, uint64_t* out) {
  std::lock_guard<std::mutex> lk(m->mu);
  const size_t mask = m->keys.size() - 1;
  size_t i = fm_hash(key) & mask;
  while (m->states[i] != tb_flatmap::EMPTY) {
    if (m->states[i] == tb_flatmap::FULL && m->keys[i] == key) {
      if (out) *out = m->vals[i];
      return 1;
    }
    i = (i + 1) & mask;
  }
  return 0;
}

int tb_flatmap_erase(tb_flatmap* m, uint64_t key) {
  std::lock_guard<std::mutex> lk(m->mu);
  const size_t mask = m->keys.size() - 1;
  size_t i = fm_hash(key) & mask;
  while (m->states[i] != tb_flatmap::EMPTY) {
    if (m->states[i] == tb_flatmap::FULL && m->keys[i] == key) {
      m->states[i] = tb_flatmap::TOMB;
      --m->nfull;
      return 1;
    }
    i = (i + 1) & mask;
  }
  return 0;
}

size_t tb_flatmap_size(const tb_flatmap* m) {
  std::lock_guard<std::mutex> lk(m->mu);
  return m->nfull;
}
size_t tb_flatmap_capacity(const tb_flatmap* m) {
  std::lock_guard<std::mutex> lk(m->mu);
  return m->keys.size();
}

// ---------------------------------------------------------------------------
// tb_cimap — case-ignored string map (reference CaseIgnoredFlatMap,
// containers/case_ignored_flat_map.h).  Open addressing, case-folded FNV
// hash, case-insensitive equality; stored keys keep original spelling.
// ---------------------------------------------------------------------------

namespace {

inline char ci_lower(char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
}

inline uint64_t ci_hash(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;  // FNV-1a over folded bytes
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<uint8_t>(ci_lower(s[i]));
    h *= 1099511628211ull;
  }
  return h;
}

inline bool ci_equal(const std::string& a, const char* b, size_t n) {
  if (a.size() != n) return false;
  for (size_t i = 0; i < n; ++i)
    if (ci_lower(a[i]) != ci_lower(b[i])) return false;
  return true;
}

}  // namespace

struct tb_cimap {
  enum : uint8_t { EMPTY = 0, FULL = 1, TOMB = 2 };
  mutable std::mutex mu;
  std::vector<std::string> keys;
  std::vector<std::string> vals;
  std::vector<uint8_t> states;
  size_t nfull = 0;
  size_t noccupied = 0;

  void rehash(size_t newcap) {
    std::vector<std::string> ok = std::move(keys), ov = std::move(vals);
    std::vector<uint8_t> os = std::move(states);
    keys.assign(newcap, {});
    vals.assign(newcap, {});
    states.assign(newcap, EMPTY);
    nfull = noccupied = 0;
    for (size_t i = 0; i < os.size(); ++i) {
      if (os[i] != FULL) continue;
      size_t mask = keys.size() - 1;
      size_t j = ci_hash(ok[i].data(), ok[i].size()) & mask;
      while (states[j] == FULL) j = (j + 1) & mask;
      keys[j] = std::move(ok[i]);
      vals[j] = std::move(ov[i]);
      states[j] = FULL;
      ++nfull;
      ++noccupied;
    }
  }

  // slot of the key (FULL) or of the first insertable slot; found tells
  long probe(const char* key, size_t n, bool* found) const {
    size_t mask = keys.size() - 1;
    size_t j = ci_hash(key, n) & mask;
    long first_free = -1;
    for (size_t step = 0; step < keys.size(); ++step, j = (j + 1) & mask) {
      if (states[j] == EMPTY) {
        *found = false;
        return first_free >= 0 ? first_free : static_cast<long>(j);
      }
      if (states[j] == TOMB) {
        if (first_free < 0) first_free = static_cast<long>(j);
        continue;
      }
      if (ci_equal(keys[j], key, n)) {
        *found = true;
        return static_cast<long>(j);
      }
    }
    *found = false;
    return first_free;
  }
};

tb_cimap* tb_cimap_create(size_t initial_capacity) {
  size_t cap = 16;
  while (cap < initial_capacity) cap <<= 1;
  tb_cimap* m = new (std::nothrow) tb_cimap();
  if (m == nullptr) return nullptr;
  m->keys.assign(cap, {});
  m->vals.assign(cap, {});
  m->states.assign(cap, tb_cimap::EMPTY);
  return m;
}

void tb_cimap_destroy(tb_cimap* m) { delete m; }

int tb_cimap_set(tb_cimap* m, const char* key, size_t klen, const char* val,
                 size_t vlen) {
  std::lock_guard<std::mutex> lk(m->mu);
  if ((m->noccupied + 1) * 4 >= m->keys.size() * 3) {
    // grow only when LIVE entries justify it; a tombstone-dominated table
    // rehashes in place (same capacity), so insert/erase churn with a
    // small live set cannot grow memory without bound
    size_t newcap = m->keys.size();
    if ((m->nfull + 1) * 4 >= newcap * 3) newcap *= 2;
    m->rehash(newcap);
  }
  bool found = false;
  long j = m->probe(key, klen, &found);
  if (j < 0) return -1;
  if (found) {
    m->vals[j].assign(val, vlen);
    return 1;
  }
  if (m->states[j] == tb_cimap::EMPTY) ++m->noccupied;
  m->keys[j].assign(key, klen);
  m->vals[j].assign(val, vlen);
  m->states[j] = tb_cimap::FULL;
  ++m->nfull;
  return 0;
}

long tb_cimap_get(const tb_cimap* m, const char* key, size_t klen, char* out,
                  size_t cap) {
  std::lock_guard<std::mutex> lk(m->mu);
  bool found = false;
  long j = m->probe(key, klen, &found);
  if (!found || j < 0) return -1;
  const std::string& v = m->vals[j];
  size_t n = v.size() < cap ? v.size() : cap;
  if (out != nullptr && n > 0) memcpy(out, v.data(), n);
  return static_cast<long>(v.size());
}

int tb_cimap_erase(tb_cimap* m, const char* key, size_t klen) {
  std::lock_guard<std::mutex> lk(m->mu);
  bool found = false;
  long j = m->probe(key, klen, &found);
  if (!found || j < 0) return 0;
  m->keys[j].clear();
  m->vals[j].clear();
  m->states[j] = tb_cimap::TOMB;
  --m->nfull;
  return 1;
}

size_t tb_cimap_size(const tb_cimap* m) {
  std::lock_guard<std::mutex> lk(m->mu);
  return m->nfull;
}

long tb_cimap_key_at(const tb_cimap* m, size_t i, char* out, size_t cap) {
  std::lock_guard<std::mutex> lk(m->mu);
  size_t seen = 0;
  for (size_t j = 0; j < m->keys.size(); ++j) {
    if (m->states[j] != tb_cimap::FULL) continue;
    if (seen++ == i) {
      const std::string& k = m->keys[j];
      size_t n = k.size() < cap ? k.size() : cap;
      if (out != nullptr && n > 0) memcpy(out, k.data(), n);
      return static_cast<long>(k.size());
    }
  }
  return -1;
}

// ---------------------------------------------------------------------------
// tb_mru — MRU cache (reference MRUCache, containers/mru_cache.h): a
// doubly-linked recency list over a hash index; puts past capacity evict
// the least-recently-used entry.
// ---------------------------------------------------------------------------

struct tb_mru {
  mutable std::mutex mu;
  size_t capacity;
  std::list<std::pair<uint64_t, uint64_t>> order;  // front = most recent
  std::unordered_map<uint64_t,
                     std::list<std::pair<uint64_t, uint64_t>>::iterator>
      index;
};

tb_mru* tb_mru_create(size_t capacity) {
  tb_mru* c = new (std::nothrow) tb_mru();
  if (c == nullptr) return nullptr;
  c->capacity = capacity < 1 ? 1 : capacity;
  return c;
}

void tb_mru_destroy(tb_mru* c) { delete c; }

int tb_mru_put(tb_mru* c, uint64_t key, uint64_t value) {
  std::lock_guard<std::mutex> lk(c->mu);
  auto it = c->index.find(key);
  if (it != c->index.end()) {
    it->second->second = value;
    c->order.splice(c->order.begin(), c->order, it->second);
    return 1;
  }
  c->order.emplace_front(key, value);
  c->index[key] = c->order.begin();
  if (c->order.size() > c->capacity) {
    c->index.erase(c->order.back().first);
    c->order.pop_back();
  }
  return 0;
}

int tb_mru_get(tb_mru* c, uint64_t key, uint64_t* out) {
  std::lock_guard<std::mutex> lk(c->mu);
  auto it = c->index.find(key);
  if (it == c->index.end()) return 0;
  if (out != nullptr) *out = it->second->second;
  c->order.splice(c->order.begin(), c->order, it->second);
  return 1;
}

size_t tb_mru_size(const tb_mru* c) {
  std::lock_guard<std::mutex> lk(c->mu);
  return c->order.size();
}

}  // extern "C"
