"""IOBuf — zero-copy block-chain buffer (reference src/butil/iobuf.h:52).

``IOBuf`` is a thin handle over the native block chain of the port's host
runtime (``csrc/host/tbutil``, loaded by ``native.py``): append/cut/share
move refcounted BlockRefs, never bytes; fd IO is vectored (writev/readv)
directly from/to blocks; external blocks wrap caller-owned memory and fire
a release callback (through ``_release_trampoline``) when the last
reference anywhere drops.

``_PyIOBuf`` is its plain version: the same API and ref-sharing in pure
Python, with fd IO copying through ``bytes``. ``IOBuf`` is the plain
version only where the library did not build (``native.BUILD_ERROR``).

An IOBuf is externally synchronized: one thread mutates it at a time (same
contract as the reference). Blocks underneath are thread-safe and may be
shared across IOBufs on different threads. A handle belongs to this
package's library: it is never handed to another package's runtime.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import threading
from typing import Callable, List, Optional

from incubator_brpc_tpu_torch.native import LIB, NATIVE_AVAILABLE, RELEASE_FN, _Ref

# keepalive registry for external blocks: token -> (buffer obj, user cb).
_external_lock = threading.Lock()
_external: dict = {}
_external_token = itertools.count(1)


@RELEASE_FN
def _release_trampoline(_data, ctx):
    with _external_lock:
        entry = _external.pop(ctx, None)
    if entry is not None and entry[1] is not None:
        try:
            entry[1](entry[0])
        except Exception:
            pass  # release runs on arbitrary (completion) threads


def _buffer_info(obj):
    """(address, nbytes) of the contiguous memory behind a buffer-protocol
    object. nbytes comes from memoryview — len() would count elements, not
    bytes, for numpy arrays and typed memoryviews. Read-only buffers (e.g.
    views of a device step's fetched output) resolve through numpy, since
    ctypes.from_buffer demands writability the wrap never needs."""
    mv = memoryview(obj)
    nbytes = mv.nbytes
    if isinstance(obj, bytes):
        # c_char_p points at the bytes object's internal storage (CPython).
        return ctypes.cast(ctypes.c_char_p(obj), ctypes.c_void_p).value, nbytes
    if mv.readonly:
        import numpy as _np

        return _np.frombuffer(mv, dtype=_np.uint8).ctypes.data, nbytes
    c = (ctypes.c_char * max(1, nbytes)).from_buffer(obj)
    return ctypes.addressof(c), nbytes


class _NativeIOBuf:
    __slots__ = ("_h",)

    def __init__(self, _handle=None):
        self._h = _handle if _handle is not None else LIB.tb_iobuf_create()

    # -- introspection --
    def __len__(self) -> int:
        return LIB.tb_iobuf_size(self._h)

    @property
    def block_count(self) -> int:
        return LIB.tb_iobuf_block_count(self._h)

    def block_shared_count(self, i: int) -> int:
        return LIB.tb_iobuf_block_shared_count(self._h, i)

    # -- append --
    def append(self, data) -> None:
        b = bytes(data) if not isinstance(data, (bytes, bytearray)) else data
        LIB.tb_iobuf_append(self._h, bytes(b), len(b))

    def append_external(
        self, obj, release_cb: Optional[Callable] = None
    ) -> None:
        """Wrap ``obj``'s memory without copying. ``obj`` is kept alive
        until the last reference (in any IOBuf) drops; then
        ``release_cb(obj)`` runs on whichever thread dropped it."""
        addr, nbytes = _buffer_info(obj)
        token = next(_external_token)
        with _external_lock:
            _external[token] = (obj, release_cb)
        LIB.tb_iobuf_append_external(
            self._h, addr, nbytes, _release_trampoline, token
        )

    def append_iobuf(self, other: "_NativeIOBuf") -> None:
        LIB.tb_iobuf_append_iobuf(self._h, other._h)

    def append_from_region(self, rid: int, data: bytes) -> bool:
        return LIB.tb_iobuf_append_from_region(self._h, rid, data, len(data)) == 0

    # -- cut / pop --
    def cutn(self, n: int) -> "_NativeIOBuf":
        out = _NativeIOBuf()
        LIB.tb_iobuf_cutn(self._h, out._h, n)
        return out

    def cut_into(self, other: "_NativeIOBuf", n: int) -> int:
        return LIB.tb_iobuf_cutn(self._h, other._h, n)

    def popn(self, n: int) -> int:
        return LIB.tb_iobuf_popn(self._h, n)

    def clear(self) -> None:
        LIB.tb_iobuf_clear(self._h)

    # -- read out --
    def to_bytes(self, n: Optional[int] = None, pos: int = 0) -> bytes:
        size = len(self)
        if n is None:
            n = size - pos if size > pos else 0
        if n <= 0:
            return b""
        out = ctypes.create_string_buffer(n)
        got = LIB.tb_iobuf_copy_to(self._h, out, n, pos)
        # string_at copies exactly `got` bytes; .raw[:got] would first
        # materialize the whole n-byte scratch (a second full copy on the
        # messenger's deep-peek path)
        return ctypes.string_at(out, got)

    def views(self) -> List[memoryview]:
        """Read-only zero-copy views of the refs. Valid only until the
        IOBuf is next mutated."""
        max_refs = self.block_count
        if max_refs == 0:
            return []
        arr = (_Ref * max_refs)()
        got = LIB.tb_iobuf_refs(self._h, arr, max_refs)
        out = []
        for i in range(got):
            buf = (ctypes.c_char * arr[i].length).from_address(arr[i].data)
            # byte-typed like the plain version's views (indexing gives ints)
            out.append(memoryview(buf).cast("B").toreadonly())
        return out

    # -- fd IO --
    def cut_into_fd(self, fd: int, max_bytes: int = 1 << 20) -> int:
        """writev ≤max_bytes; pops what was written. Returns bytes
        written, or -errno (e.g. -errno.EAGAIN)."""
        return LIB.tb_iobuf_cut_into_fd(self._h, fd, max_bytes)

    def append_from_fd(self, fd: int, max_bytes: int = 1 << 16) -> int:
        """readv ≤max_bytes into fresh blocks. 0 = EOF, <0 = -errno."""
        return LIB.tb_iobuf_append_from_fd(self._h, fd, max_bytes)

    def append_from_fd_bulk(self, fd: int, max_bytes: int, block_bytes: int) -> int:
        """readv into BIG malloc'd blocks: the saturated-stream drain (a
        socket's reader escalates here after consecutive full bursts; see
        transport/sock.py). Same return contract as append_from_fd."""
        return LIB.tb_iobuf_append_from_fd_bulk(self._h, fd, max_bytes, block_bytes)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and LIB is not None:
            LIB.tb_iobuf_destroy(h)


class _PyBlock:
    __slots__ = ("data", "refs", "obj", "release_cb")

    def __init__(self, data: memoryview, obj=None, release_cb=None):
        self.data = data
        self.refs = 1
        self.obj = obj
        self.release_cb = release_cb

    def unref(self):
        self.refs -= 1
        if self.refs == 0 and self.release_cb is not None:
            try:
                self.release_cb(self.obj)
            except Exception:
                pass


class _PyIOBuf:
    """The plain version: the same ref-sharing semantics in pure Python
    (the JAX package's fallback chain, which was the port's only IOBuf
    before its host runtime)."""

    def __init__(self):
        self._refs: List[list] = []  # [block, offset, length]
        self._n = 0

    def __len__(self):
        return self._n

    @property
    def block_count(self):
        return len(self._refs)

    def block_shared_count(self, i):
        return self._refs[i][0].refs if i < len(self._refs) else -1

    def append(self, data):
        b = bytes(data)
        if b:
            self._refs.append([_PyBlock(memoryview(b)), 0, len(b)])
            self._n += len(b)

    def append_external(self, obj, release_cb=None):
        mv = memoryview(obj).cast("B")  # byte view: len == nbytes
        self._refs.append([_PyBlock(mv, obj, release_cb), 0, len(mv)])
        self._n += len(mv)

    def append_iobuf(self, other):
        for blk, off, ln in other._refs:
            blk.refs += 1
            self._refs.append([blk, off, ln])
            self._n += ln

    def append_from_region(self, rid, data):  # no region pool in fallback
        self.append(data)
        return True

    def cutn(self, n):
        out = _PyIOBuf()
        self.cut_into(out, n)
        return out

    def cut_into(self, other, n):
        moved = 0
        while n > 0 and self._refs:
            ref = self._refs[0]
            blk, off, ln = ref
            if ln <= n:
                other._refs.append(ref)
                other._n += ln
                self._refs.pop(0)
                self._n -= ln
                n -= ln
                moved += ln
            else:
                blk.refs += 1
                other._refs.append([blk, off, n])
                other._n += n
                ref[1] += n
                ref[2] -= n
                self._n -= n
                moved += n
                n = 0
        return moved

    def popn(self, n):
        popped = 0
        while n > 0 and self._refs:
            ref = self._refs[0]
            blk, off, ln = ref
            if ln <= n:
                self._refs.pop(0)
                self._n -= ln
                n -= ln
                popped += ln
                blk.unref()
            else:
                ref[1] += n
                ref[2] -= n
                self._n -= n
                popped += n
                n = 0
        return popped

    def clear(self):
        for blk, _, _ in self._refs:
            blk.unref()
        self._refs = []
        self._n = 0

    def to_bytes(self, n=None, pos=0):
        out = bytearray()
        if n is None:
            n = self._n
        for blk, off, ln in self._refs:
            if n <= 0:
                break
            if pos >= ln:
                pos -= ln
                continue
            take = min(n, ln - pos)
            out += blk.data[off + pos : off + pos + take]
            n -= take
            pos = 0
        return bytes(out)

    def views(self):
        return [blk.data[off : off + ln] for blk, off, ln in self._refs]

    def cut_into_fd(self, fd, max_bytes=1 << 20):
        data = self.to_bytes(min(max_bytes, self._n))
        try:
            nw = os.write(fd, data)
        except OSError as e:
            return -e.errno
        self.popn(nw)
        return nw

    def append_from_fd_bulk(self, fd, max_bytes, block_bytes):
        return self.append_from_fd(fd, max_bytes)

    def append_from_fd(self, fd, max_bytes=1 << 16):
        try:
            data = os.read(fd, max_bytes)
        except OSError as e:
            return -e.errno
        self.append(data)
        return len(data)

    def __del__(self):
        # match native destroy semantics: external release callbacks fire
        # when a GC'd plain IOBuf held the last reference
        try:
            self.clear()
        except Exception:
            pass


IOBuf = _NativeIOBuf if NATIVE_AVAILABLE else _PyIOBuf


def read_burst_bytes() -> int:
    """Bytes one append_from_fd readv can deliver (native iovec budget ×
    current block size) — read loops must size asks and short-read tests
    from this, not a magic constant."""
    return LIB.tb_iobuf_read_burst() if LIB is not None else 1 << 16


def block_pool_stats() -> dict:
    if LIB is None:
        return {"live": -1, "cached": -1}
    live = ctypes.c_size_t()
    cached = ctypes.c_size_t()
    LIB.tb_block_pool_stats(ctypes.byref(live), ctypes.byref(cached))
    return {"live": live.value, "cached": cached.value}


def register_region(buf, block_bytes: int) -> int:
    """Register caller-owned memory (e.g. a pinned numpy array) as a block
    region (reference rdma/block_pool.h:20-66). Returns region id."""
    if LIB is None:
        return -1
    addr, nbytes = _buffer_info(buf)
    rid = LIB.tb_region_register(addr, nbytes, block_bytes)
    if rid >= 0:
        with _external_lock:
            _external[-(rid + 1)] = (buf, None)  # pin slab forever
    return rid


def region_free_blocks(rid: int) -> int:
    return LIB.tb_region_free_blocks(rid) if LIB is not None else 0
