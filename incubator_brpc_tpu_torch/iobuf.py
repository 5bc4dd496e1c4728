"""IOBuf — block-chain buffer (reference src/butil/iobuf.h:52).

The port's copy of the JAX package's pure-Python IOBuf (the class that
package uses when its native library is not built): append/cut/share move
refcounted block references, external blocks wrap caller-owned memory and
fire a release callback when the last reference drops. The port has no
native block chain yet, so fd IO copies through ``bytes``.

An IOBuf is externally synchronized: one thread mutates it at a time (same
contract as the reference).
"""

from __future__ import annotations

import os
from typing import List


class _Block:
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


class IOBuf:
    """A chain of [block, offset, length] references."""

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
            self._refs.append([_Block(memoryview(b)), 0, len(b)])
            self._n += len(b)

    def append_external(self, obj, release_cb=None):
        mv = memoryview(obj).cast("B")  # byte view: len == nbytes
        self._refs.append([_Block(mv, obj, release_cb), 0, len(mv)])
        self._n += len(mv)

    def append_iobuf(self, other):
        for blk, off, ln in other._refs:
            blk.refs += 1
            self._refs.append([blk, off, ln])
            self._n += ln

    def cutn(self, n):
        out = IOBuf()
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

    def append_from_fd(self, fd, max_bytes=1 << 16):
        try:
            data = os.read(fd, max_bytes)
        except OSError as e:
            return -e.errno
        self.append(data)
        return len(data)

    def __del__(self):
        # external release callbacks fire when a GC'd IOBuf held the last
        # reference
        try:
            self.clear()
        except Exception:
            pass


def read_burst_bytes() -> int:
    """Bytes one ``append_from_fd`` read can deliver — read loops size their
    asks and short-read tests from this, not a magic constant."""
    return 1 << 16
