// tbutil — native L1 base for the TPU-native brpc-class framework.
//
// Re-designed counterpart of the reference's butil core
// (reference src/butil/iobuf.h:52, iobuf.cpp:221-306,
//  resource_pool.h:24-83, rdma/block_pool.h:20-66).  NOT a port: the
// reference interleaves a Chromium base fork; this is a from-scratch,
// minimal, C-ABI surface designed to be driven from Python via ctypes and
// from future native transports directly.
//
// Key properties kept from the reference design:
//   * IOBuf = queue of refcounted BlockRef{block, offset, length}; O(1)
//     cut/append/share; no data copies between IOBufs.
//   * Blocks come from a TLS-cached pool; refcounts are atomic; an IOBuf
//     itself is externally synchronized (one owner thread at a time).
//   * External blocks wrap caller-owned memory (the HBM/registered-memory
//     hook) and fire a release callback when the last ref drops — the
//     IOBUF_HUGE_BLOCK / Block::release_cb design (iobuf.cpp:258-306).
//   * Region allocator: carve fixed blocks out of one registered slab
//     (modeled on rdma/block_pool) so payloads can live in pinned/device
//     memory end to end.
//   * ResourcePool: never-freeing slab of fixed-size items addressed by
//     versioned 64-bit ids (ABA-safe) — backs socket/stream id tables.
#ifndef TBUTIL_H
#define TBUTIL_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct tb_iobuf tb_iobuf;
typedef void (*tb_release_fn)(void* data, void* ctx);

typedef struct tb_ref_view {
  const void* data;
  size_t length;
} tb_ref_view;

// ---- block pool ----
// Default block payload size (bytes). Changing it only affects new blocks.
void tb_set_block_size(size_t bytes);
size_t tb_block_size(void);
// blocks currently live (allocated - freed), blocks parked in caches.
void tb_block_pool_stats(size_t* live, size_t* cached);
// bytes one tb_iobuf_append_from_fd readv can deliver (iovec budget x
// current block size) — read loops size their asks and short-read tests
// from this so the contract lives in ONE place.
size_t tb_iobuf_read_burst(void);

// ---- IOBuf ----
// Handles are placement-new'd over ObjectPool slots (never freed to the
// OS); stats expose the pool's live/free counts for tests and /ids.
tb_iobuf* tb_iobuf_create(void);
void tb_iobuf_handle_pool_stats(size_t* live, size_t* free_count);
void tb_iobuf_destroy(tb_iobuf* b);
void tb_iobuf_clear(tb_iobuf* b);
size_t tb_iobuf_size(const tb_iobuf* b);
size_t tb_iobuf_block_count(const tb_iobuf* b);
// copy n bytes in (fills the tail block first — the portal-append path).
void tb_iobuf_append(tb_iobuf* b, const void* data, size_t n);
// zero-copy wrap of caller-owned memory; cb(data, ctx) fires when the last
// ref drops, on whichever thread drops it (keep cb cheap; see
// reference iobuf.cpp:258-306 on why release must not block).
void tb_iobuf_append_external(tb_iobuf* b, void* data, size_t n,
                              tb_release_fn cb, void* ctx);
// share `from`'s refs into `to` (refcount bump, no copy).
void tb_iobuf_append_iobuf(tb_iobuf* to, const tb_iobuf* from);
// move up to n bytes from the front of `from` to the back of `to`; O(blocks).
size_t tb_iobuf_cutn(tb_iobuf* from, tb_iobuf* to, size_t n);
// drop up to n front bytes.
size_t tb_iobuf_popn(tb_iobuf* from, size_t n);
// copy out [pos, pos+n) without consuming; returns bytes copied.
size_t tb_iobuf_copy_to(const tb_iobuf* b, void* out, size_t n, size_t pos);
// expose up to max {ptr,len} views of the refs (zero-copy read from Python).
int tb_iobuf_refs(const tb_iobuf* b, tb_ref_view* out, int max);
// white-box: refcount of the i-th ref's block (tests; reference
// iobuf.cpp:329 block_shared_count).
int tb_iobuf_block_shared_count(const tb_iobuf* b, size_t i);

// ---- fd IO (vectored, zero-copy w.r.t. Python) ----
// writev the first <=max_bytes; pops what was written. Returns bytes
// written, or -errno.
long tb_iobuf_cut_into_fd(tb_iobuf* b, int fd, size_t max_bytes);
// readv up to max_bytes into fresh pool blocks appended to b. Returns bytes
// read (0 on EOF), or -errno.
long tb_iobuf_append_from_fd(tb_iobuf* b, int fd, size_t max_bytes);
// bulk streaming drains: big SRC_MALLOC blocks instead of the pooled default
long tb_iobuf_append_from_fd_bulk(tb_iobuf* b, int fd, size_t max_bytes,
                                  size_t block_bytes);

// ---- region allocator (registered-slab blocks; rdma/block_pool analog) ----
// Carve `total` into fixed `block_bytes` blocks over caller memory `base`
// (caller keeps ownership of the slab; must outlive the region's blocks).
// Returns region id >=0, or -1.
int tb_region_register(void* base, size_t total, size_t block_bytes);
// Append n bytes into `b` copied into blocks drawn from region `rid`.
// Returns 0, or -1 if the region is exhausted.
int tb_iobuf_append_from_region(tb_iobuf* b, int rid, const void* data,
                                size_t n);
// free blocks available in region.
size_t tb_region_free_blocks(int rid);

// ---- wire fast path (tbus_std framing; reference splits this between
// policy/baidu_rpc_protocol.cpp pack/parse and input_messenger.cpp's cut
// loop — here the whole per-frame byte path is native so Python never
// copies or checksums payload bytes) ----

// CRC32C (Castagnoli) with zlib-style chaining: seed 0 to start, feed the
// previous return value to continue. Uses SSE4.2 hardware CRC when the CPU
// has it (one u64 step per cycle), a slice-table otherwise.
uint32_t tb_crc32c(uint32_t seed, const void* data, size_t n);
// CRC32C over [pos, pos+n) of the chain without copying.
uint32_t tb_iobuf_crc32c(const tb_iobuf* b, uint32_t seed, size_t pos,
                         size_t n);

typedef struct tb_tbus_hdr {
  uint32_t body_len;
  uint32_t flags;
  uint32_t cid_lo;
  uint32_t cid_hi;
  uint32_t meta_len;
  uint32_t crc;
  uint32_t error_code;
} tb_tbus_hdr;

// Peek the fixed 32-byte header off the front of `in` without consuming.
// 0 = filled `out`; 1 = fewer than 32 bytes buffered; -1 = bad magic.
int tb_tbus_peek(const tb_iobuf* in, tb_tbus_hdr* out);
// Consume one complete frame: verify CRC32C (over the meta, or the whole
// body when header flag bit 3 is set) by walking the block refs (no copy),
// pop the header, copy the (small) meta into `meta_out` (capacity >=
// hdr->meta_len), and CUT payload+attachment into `body_out` zero-copy
// (refs move, bytes don't).
// 0 = ok; 1 = frame incomplete; -2 = crc mismatch (nothing consumed);
// -3 = malformed (meta_len > body_len).
int tb_tbus_cut(tb_iobuf* in, const tb_tbus_hdr* hdr, void* meta_out,
                tb_iobuf* body_out);
// Append header + meta to `out`, computing the CRC32C over meta (and over
// payload+attachment too when flags bit 3 is set) in one native pass.
// copy_body != 0: payload+attachment are appended (copied) too — the whole
// frame in ONE call, right for small frames. copy_body == 0: the caller
// appends them after (zero-copy via append_external if large).
void tb_tbus_pack(tb_iobuf* out, const void* meta, size_t meta_len,
                  const void* payload, size_t payload_len, const void* att,
                  size_t att_len, uint32_t cid_lo, uint32_t cid_hi,
                  uint32_t flags, uint32_t error_code, int copy_body);

// ---- misc ----
uint32_t tb_crc32(uint32_t seed, const void* data, size_t n);
uint64_t tb_fast_rand(void);
uint64_t tb_fast_rand_less_than(uint64_t bound);
// monotonic ns (CLOCK_MONOTONIC; the cpuwide_time analog).
uint64_t tb_monotonic_ns(void);

// ---- ResourcePool: versioned-id slab, never frees (ABA-safe ids) ----
typedef struct tb_respool tb_respool;
tb_respool* tb_respool_create(size_t item_size);
void tb_respool_destroy(tb_respool* p);
// allocate a slot; *out_id = (version<<32)|slot; returns item ptr.
void* tb_respool_get(tb_respool* p, uint64_t* out_id);
// resolve id; NULL if the slot's version moved on (the Address-after-
// SetFailed contract of socket versioned refs).
void* tb_respool_address(tb_respool* p, uint64_t id);
// bump version and recycle slot; returns 0 or -1 if id stale.
int tb_respool_return(tb_respool* p, uint64_t id);
size_t tb_respool_live(const tb_respool* p);

// ---- ObjectPool: fixed-size objects addressed by pointer, free-listed,
// never returned to the OS (reference src/butil/object_pool.h) ----
typedef struct tb_objpool tb_objpool;
tb_objpool* tb_objpool_create(size_t item_size);
void tb_objpool_destroy(tb_objpool* p);
void* tb_objpool_get(tb_objpool* p);
// return an item obtained from this pool; it becomes reusable immediately.
void tb_objpool_return(tb_objpool* p, void* item);
size_t tb_objpool_live(const tb_objpool* p);
size_t tb_objpool_free_count(const tb_objpool* p);

// ---- FlatMap: open-addressing u64->u64 hash map for hot-path id lookups
// (reference src/butil/containers/flat_map.h; this is the narrow typed
// variant native transports need — socket ids, stream ids, cids) ----
typedef struct tb_flatmap tb_flatmap;
tb_flatmap* tb_flatmap_create(size_t initial_capacity);
void tb_flatmap_destroy(tb_flatmap* m);
// 0 = inserted new, 1 = replaced existing, -1 = OOM on grow.
int tb_flatmap_insert(tb_flatmap* m, uint64_t key, uint64_t value);
// 1 = found (*out filled), 0 = absent.
int tb_flatmap_get(const tb_flatmap* m, uint64_t key, uint64_t* out);
// 1 = erased, 0 = absent.
int tb_flatmap_erase(tb_flatmap* m, uint64_t key);
size_t tb_flatmap_size(const tb_flatmap* m);
size_t tb_flatmap_capacity(const tb_flatmap* m);

// Case-ignored string map (reference CaseIgnoredFlatMap,
// containers/case_ignored_flat_map.h — HTTP header tables): open
// addressing keyed by case-folded hash with case-insensitive equality;
// stored keys keep their original spelling.
typedef struct tb_cimap tb_cimap;
tb_cimap* tb_cimap_create(size_t initial_capacity);
void tb_cimap_destroy(tb_cimap* m);
// 0 = inserted new, 1 = replaced existing value, -1 = OOM.
int tb_cimap_set(tb_cimap* m, const char* key, size_t klen, const char* val,
                 size_t vlen);
// value length (>=0, copied into out up to cap) or -1 when absent.  A
// value longer than cap is truncated to cap; the true length returns.
long tb_cimap_get(const tb_cimap* m, const char* key, size_t klen, char* out,
                  size_t cap);
// 1 = erased, 0 = absent.
int tb_cimap_erase(tb_cimap* m, const char* key, size_t klen);
size_t tb_cimap_size(const tb_cimap* m);
// iterate: copies the i-th live entry's key into out (original spelling);
// returns key length or -1 past the end.  Order is unspecified but stable
// between mutations.
long tb_cimap_key_at(const tb_cimap* m, size_t i, char* out, size_t cap);

// MRU cache (reference MRUCache, containers/mru_cache.h): u64→u64 with a
// capacity bound; get/put move the entry to the front, inserts past
// capacity evict the least-recently-used entry.
typedef struct tb_mru tb_mru;
tb_mru* tb_mru_create(size_t capacity);
void tb_mru_destroy(tb_mru* c);
// 0 = inserted, 1 = replaced; evicts LRU when over capacity.
int tb_mru_put(tb_mru* c, uint64_t key, uint64_t value);
// 1 = hit (*out filled, entry freshened), 0 = miss.
int tb_mru_get(tb_mru* c, uint64_t key, uint64_t* out);
size_t tb_mru_size(const tb_mru* c);

#ifdef __cplusplus
}
#endif
#endif  // TBUTIL_H
