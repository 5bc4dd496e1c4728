"""The port's native host runtime (``incubator_brpc_tpu_torch/native.py``
over ``csrc/host``, built into ``incubator_brpc_tpu_torch/_build/``) on the
CPU, held against the JAX package's ``native.py`` (``src/build``):

- the library loaded from the port's own build, and it is not the JAX
  package's file;
- tests/test_native_containers.py's ``TestObjectPool``, ``TestFlatMap``,
  ``TestCaseIgnoredMap``, ``TestMRUCache``, ``TestWriteBacklogContinuation``
  and ``TestContainersLoadBearing`` (the socket registry on the native
  ``ResourcePool``, the server's method map on the native ``FlatMap``, IOBuf
  handles on the object pool), each run on both packages with the answers
  the JAX test asserts;
- ``crc32`` and ``crc32c`` over seeded lengths from 0 to 64 KiB with
  chained seeds: the port's equal to the JAX package's and to the plain
  twins (zlib's crc32, ``utils/crc32c.crc32c_plain``), bit for bit;
- tests/test_iobuf.py's cases on the port's native IOBuf, its plain
  version and the JAX package's native IOBuf, and its native-only cases on
  both packages;
- tbus_std frames packed natively (``pack_frame_iobuf``) byte-identical to
  the JAX package's and to the port's Python packer, with and without the
  body checksum, and each cut (the port's native and plain, the JAX
  package's) reading every packer's frames back.

Not here: tests/test_native_containers.py's ``TestFiberMutex``,
``TestFiberCond`` and ``TestCountdownEvent`` (``runtime/mutex.py``), which
run on both packages in tests/test_torch_hotspots_logging.py. Tolerance:
none, everything is bytes and integers.
"""

import ctypes
import os
import socket
import threading
import time
import types
import zlib

import numpy as np
import pytest

import incubator_brpc_tpu.iobuf as jax_iobuf
import incubator_brpc_tpu.native as jax_native
import incubator_brpc_tpu.rpc as jax_rpc
import incubator_brpc_tpu.transport.sock as jax_sock
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.utils.flags import set_flag as jax_set_flag
import incubator_brpc_tpu_torch.iobuf as port_iobuf
import incubator_brpc_tpu_torch.native as port_native
import incubator_brpc_tpu_torch.rpc as port_rpc
import incubator_brpc_tpu_torch.transport.sock as port_sock
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread
from incubator_brpc_tpu_torch.utils.crc32c import crc32c_plain
from incubator_brpc_tpu_torch.utils.flags import set_flag as port_set_flag

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", native=jax_native, iobuf=jax_iobuf, sock=jax_sock, rpc=jax_rpc, server_kw={},
    ),
    "torch": types.SimpleNamespace(
        name="torch", native=port_native, iobuf=port_iobuf, sock=port_sock, rpc=port_rpc,
        server_kw={"device": "cpu"},
    ),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    port_rpc.shutdown_host_plane()
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


def test_the_port_loads_its_own_build():
    assert port_native.NATIVE_AVAILABLE and port_native.BUILD_ERROR is None
    path = port_native.library_path()
    assert path.exists() and path.parent == port_native.BUILD_DIR
    assert path.name.startswith("libtbtorch_host-")
    assert os.path.realpath(path) != os.path.realpath(jax_native._LIB_PATH)
    assert port_native.LIB is not jax_native.LIB
    # every declared symbol of the ABI table resolved in the port's library
    for name in port_native.SIGNATURES:
        assert getattr(port_native.LIB, name).argtypes is not None
    assert set(port_native.SIGNATURES) == set(jax_native.SIGNATURES)
    for src in port_native.SOURCES + port_native.HEADERS:
        assert src.is_file() and "csrc/host" in str(src)


def test_each_package_keeps_its_own_block_pool():
    before = jax_iobuf.block_pool_stats()["live"]
    b = port_iobuf.IOBuf()
    b.append(os.urandom(64_000))
    assert port_iobuf.block_pool_stats()["live"] >= 8
    assert jax_iobuf.block_pool_stats()["live"] == before
    b.clear()


# -- tests/test_native_containers.py ------------------------------------------


class TestObjectPool:
    def test_get_return_reuses(self, pkg):
        p = pkg.native.ObjectPool(item_size=64)
        a = p.get()
        b = p.get()
        assert a and b and a != b
        assert p.live == 2
        p.return_(a)
        assert p.free_count == 1
        c = p.get()  # freelist pop: same address back
        assert c == a
        assert p.live == 2

    def test_many_items_distinct(self, pkg):
        p = pkg.native.ObjectPool(item_size=16)
        addrs = {p.get() for _ in range(1000)}
        assert len(addrs) == 1000
        assert p.live == 1000


class TestFlatMap:
    def test_insert_get_erase(self, pkg):
        m = pkg.native.FlatMap()
        m[42] = 4242
        m[0] = 7  # key 0 must work
        assert m[42] == 4242
        assert m[0] == 7
        assert 42 in m and 0 in m and 99 not in m
        assert len(m) == 2
        m[42] = 43
        assert m[42] == 43 and len(m) == 2
        del m[42]
        assert 42 not in m and len(m) == 1
        with pytest.raises(KeyError):
            _ = m[42]
        with pytest.raises(KeyError):
            del m[42]

    def test_growth_and_probe_chains(self, pkg):
        m = pkg.native.FlatMap(initial_capacity=16)
        n = 10_000
        for i in range(n):
            m[i * 0x9E3779B9] = i
        assert len(m) == n
        assert m.capacity >= n
        for i in range(n):
            assert m[i * 0x9E3779B9] == i

    def test_tombstone_reuse(self, pkg):
        m = pkg.native.FlatMap(initial_capacity=16)
        for i in range(1, 1000):
            m[i] = i
            del m[i]
        assert len(m) == 0
        assert m.capacity <= 64

    def test_concurrent_mutation_is_safe(self, pkg):
        m = pkg.native.FlatMap()
        errs = []

        def worker(base):
            try:
                for i in range(2000):
                    k = base + i
                    m[k] = k * 2
                    assert m[k] == k * 2
                    del m[k]
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(t * 1_000_000,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        assert len(m) == 0


class TestCaseIgnoredMap:
    def test_case_insensitive_lookup_preserves_spelling(self, pkg):
        m = pkg.native.CaseIgnoredMap()
        m["Content-Type"] = "text/plain"
        assert m["content-type"] == "text/plain"
        assert m["CONTENT-TYPE"] == "text/plain"
        assert "cOnTeNt-TyPe" in m
        assert m.keys() == ["Content-Type"]  # original spelling kept
        m["CONTENT-type"] = "application/json"  # replace via other casing
        assert len(m) == 1
        assert m["content-type"] == "application/json"

    def test_erase_and_missing(self, pkg):
        m = pkg.native.CaseIgnoredMap()
        m["X-A"] = "1"
        m["X-B"] = ""
        assert m.get("x-b") == ""  # empty values round-trip
        del m["x-a"]
        assert m.get("X-A") is None
        with pytest.raises(KeyError):
            del m["x-a"]
        assert len(m) == 1

    def test_growth_and_tombstones(self, pkg):
        m = pkg.native.CaseIgnoredMap(initial_capacity=4)
        for i in range(200):
            m[f"Header-{i}"] = str(i)
        for i in range(0, 200, 2):
            del m[f"header-{i}"]
        for i in range(200):
            want = None if i % 2 == 0 else str(i)
            assert m.get(f"HEADER-{i}") == want
        assert len(m) == 100


class TestMRUCache:
    def test_eviction_order(self, pkg):
        c = pkg.native.MRUCache(3)
        for k in (1, 2, 3):
            c.put(k, k * 10)
        assert c.get(1) == 10  # freshen 1
        c.put(4, 40)  # evicts 2 (least recently used)
        assert 2 not in c
        assert c.get(1) == 10 and c.get(3) == 30 and c.get(4) == 40
        assert len(c) == 3

    def test_put_replaces_and_freshens(self, pkg):
        c = pkg.native.MRUCache(2)
        assert c.put(7, 1) is False
        assert c.put(7, 2) is True  # replace
        c.put(8, 3)
        c.put(7, 4)  # freshen 7
        c.put(9, 5)  # evicts 8
        assert 8 not in c and c.get(7) == 4 and c.get(9) == 5


class TestWriteBacklogContinuation:
    def test_multi_mb_backlog_drains_past_the_iovec_ceiling(self, pkg):
        # 256 iovecs x 8 KB blocks = 2 MB a writev: the continuation loop
        # must push a larger backlog of SMALL blocks through one call per
        # kernel-buffer fill
        a, b = socket.socketpair()
        a.setblocking(False)
        buf = pkg.iobuf.IOBuf()
        chunk = bytes(range(256)) * 16  # 4 KB pieces -> many blocks
        total = 8 << 20
        for _ in range(total // len(chunk)):
            buf.append(chunk)
        got = bytearray()
        done = threading.Event()

        def reader():
            while len(got) < total:
                data = b.recv(1 << 20)
                if not data:
                    break
                got.extend(data)
            done.set()

        t = threading.Thread(target=reader)
        t.start()
        calls = 0
        deadline = time.monotonic() + 30
        while len(buf) and time.monotonic() < deadline:
            rc = buf.cut_into_fd(a.fileno(), max_bytes=total)
            calls += 1
            if rc <= 0:
                time.sleep(0.005)  # EAGAIN: the reader drains
        assert len(buf) == 0
        assert done.wait(10)
        a.close(), b.close()
        t.join(5)
        assert bytes(got) == chunk * (total // len(chunk))
        assert calls < total // (2 << 20) * 100  # one call a buffer fill


class TestContainersLoadBearing:
    def test_socket_registry_runs_on_native_respool(self, pkg):
        registry = pkg.sock._registry
        assert registry._pool is not None  # tb_respool, not a Python slab
        before = registry.live_count()
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        srv.add_service("t", {"echo": lambda cntl, req: req})
        assert srv.start(0)
        try:
            ch = pkg.rpc.Channel()
            assert ch.init(f"127.0.0.1:{srv.port}")
            assert ch.call_method("t", "echo", b"x").ok()
            assert registry.live_count() > before  # live sockets slabbed
            server_ep = ch._single_server if pkg.name == "jax" else ch._server
            sock = ch._socket_map.get_or_create(server_ep)
            sid = sock.id
            assert pkg.sock.address_socket(sid) is sock
            sock.recycle()
            assert pkg.sock.address_socket(sid) is None  # stale version: ABA-safe
        finally:
            srv.stop()
            srv.join(timeout=5)

    def test_server_method_map_runs_on_native_flatmap(self, pkg):
        srv = pkg.rpc.Server(pkg.rpc.ServerOptions(**pkg.server_kw))
        srv.add_service("svc", {"a": lambda c, r: r, "b": lambda c, r: r})
        assert srv._methods._fm is not None
        assert len(srv._methods._fm) == 2  # the tb_flatmap holds the rows
        assert srv._methods.get("svc.a") is not None
        assert srv._methods.get("svc.a").full_name == "svc.a"
        assert srv._methods.get("svc.nope") is None
        assert "svc.b" in srv._methods

    def test_method_map_keys_are_the_jax_packages(self):
        port_map = port_rpc.Server(port_rpc.ServerOptions(device="cpu"))._methods
        jax_map = jax_rpc.Server()._methods
        for name in ("svc.a", "Echo.echo", "_tpu_transport.collective_dispatch", "x" * 300):
            assert port_map._key(name) == jax_map._key(name)

    def test_iobuf_handles_ride_the_object_pool(self, pkg):
        lib = pkg.native.LIB

        def stats():
            live = ctypes.c_size_t()
            free = ctypes.c_size_t()
            lib.tb_iobuf_handle_pool_stats(ctypes.byref(live), ctypes.byref(free))
            return live.value, free.value

        bufs = [pkg.iobuf.IOBuf() for _ in range(32)]
        live1, _ = stats()
        del bufs
        live2, free2 = stats()
        assert live2 <= live1 - 32  # all 32 handles returned to the pool
        assert free2 >= 32  # ...and parked for reuse, never freed
        again = [pkg.iobuf.IOBuf() for _ in range(16)]
        live3, free3 = stats()
        assert live3 == live2 + 16
        assert free3 <= free2 - 16 + 1  # slots came from the free list
        del again


# -- CRC32 and CRC32C -----------------------------------------------------------

CRC_LENGTHS = [0, 1, 2, 3, 7, 8, 9, 15, 16, 17, 63, 64, 65, 255, 1000, 4095, 4096, 4097, 40_000,
               65_535, 65_536]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32_and_crc32c_are_the_jax_packages_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    chained32 = chained32c = seed
    for n in CRC_LENGTHS:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        c32 = port_native.crc32(data, chained32)
        assert c32 == jax_native.crc32(data, chained32) == zlib.crc32(data, chained32) & 0xFFFFFFFF
        c32c = port_native.crc32c(data, chained32c)
        assert c32c == jax_native.crc32c(data, chained32c) == crc32c_plain(data, chained32c)
        chained32, chained32c = c32, c32c
    # chaining: two pieces equal the whole
    a, b = rng.bytes(5000), rng.bytes(3001)
    assert port_native.crc32c(b, port_native.crc32c(a)) == port_native.crc32c(a + b)
    assert port_native.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# -- tests/test_iobuf.py --------------------------------------------------------

IMPLS = {
    "port-native": port_iobuf._NativeIOBuf,
    "port-plain": port_iobuf._PyIOBuf,
    "jax-native": jax_iobuf._NativeIOBuf,
}
NATIVE_IMPLS = (port_iobuf._NativeIOBuf, jax_iobuf._NativeIOBuf)


def test_the_port_iobuf_is_the_native_chain():
    assert port_iobuf.IOBuf is port_iobuf._NativeIOBuf


@pytest.mark.parametrize("impl", list(IMPLS.values()), ids=list(IMPLS))
class TestIOBufSemantics:
    def test_append_roundtrip(self, impl):
        b = impl()
        b.append(b"hello ")
        b.append(b"world")
        assert len(b) == 11
        assert b.to_bytes() == b"hello world"

    def test_large_append_spans_blocks(self, impl):
        b = impl()
        data = os.urandom(50_000)
        b.append(data)
        assert len(b) == len(data)
        assert b.to_bytes() == data
        if impl in NATIVE_IMPLS:
            assert b.block_count >= 5

    def test_cutn_moves_bytes(self, impl):
        b = impl()
        b.append(b"abcdefghij")
        head = b.cutn(4)
        assert head.to_bytes() == b"abcd"
        assert b.to_bytes() == b"efghij"
        assert len(b) == 6

    def test_cut_more_than_size(self, impl):
        b = impl()
        b.append(b"xy")
        out = b.cutn(10)
        assert out.to_bytes() == b"xy"
        assert len(b) == 0

    def test_share_bumps_refcount_no_copy(self, impl):
        a = impl()
        a.append(b"shared-bytes")
        c = impl()
        c.append_iobuf(a)
        assert c.to_bytes() == b"shared-bytes"
        assert a.to_bytes() == b"shared-bytes"
        assert a.block_shared_count(0) == 2
        c.clear()
        assert a.block_shared_count(0) == 1

    def test_partial_cut_shares_block(self, impl):
        a = impl()
        a.append(b"0123456789")
        head = a.cutn(3)
        assert head.block_shared_count(0) == 2
        assert a.block_shared_count(0) == 2
        assert head.to_bytes() == b"012"
        assert a.to_bytes() == b"3456789"

    def test_popn(self, impl):
        b = impl()
        b.append(b"0123456789")
        assert b.popn(4) == 4
        assert b.to_bytes() == b"456789"
        assert b.popn(100) == 6
        assert len(b) == 0

    def test_copy_to_with_pos(self, impl):
        b = impl()
        b.append(b"0123")
        b.append(b"4567")
        assert b.to_bytes(4, pos=2) == b"2345"
        assert len(b) == 8  # non-consuming

    def test_external_release_after_last_ref(self, impl):
        released = []
        buf = bytearray(b"external-payload")
        a = impl()
        a.append_external(buf, release_cb=lambda o: released.append(o))
        c = impl()
        c.append_iobuf(a)
        a.clear()
        assert released == []  # c still holds a ref
        c.clear()
        assert len(released) == 1
        assert released[0] is buf

    def test_external_zero_copy_read(self, impl):
        buf = bytearray(b"zcview")
        a = impl()
        a.append_external(buf)
        assert a.to_bytes() == b"zcview"
        assert b"".join(bytes(v) for v in a.views()) == b"zcview"
        a.clear()

    def test_views_concat_equals_bytes(self, impl):
        b = impl()
        b.append(b"abc")
        b.append(os.urandom(20_000))
        total = b.to_bytes()
        assert b"".join(bytes(v) for v in b.views()) == total

    def test_append_after_cut_does_not_corrupt_shared_tail(self, impl):
        a = impl()
        a.append(b"AAAA")
        c = impl()
        c.append_iobuf(a)
        a.append(b"BBBB")
        assert c.to_bytes() == b"AAAA"
        assert a.to_bytes() == b"AAAABBBB"

    def test_fd_roundtrip(self, impl):
        s1, s2 = socket.socketpair()
        try:
            out = impl()
            payload = os.urandom(100_000)
            out.append(payload)
            received = impl()
            while len(out) > 0:
                nw = out.cut_into_fd(s1.fileno())
                assert nw > 0
                while True:
                    nr = received.append_from_fd(s2.fileno(), 1 << 20)
                    if nr <= 0 or len(received) >= len(payload) - len(out):
                        break
            while len(received) < len(payload):
                nr = received.append_from_fd(s2.fileno(), 1 << 20)
                assert nr > 0
            assert received.to_bytes() == payload
        finally:
            s1.close()
            s2.close()

    def test_fd_eagain(self, impl):
        import errno

        s1, s2 = socket.socketpair()
        try:
            s2.setblocking(False)
            got = impl()
            rc = got.append_from_fd(s2.fileno())
            assert rc == -errno.EAGAIN or rc == -errno.EWOULDBLOCK
        finally:
            s1.close()
            s2.close()


class TestNativeOnly:
    def test_crc32_matches_zlib(self, pkg):
        data = os.urandom(4096)
        assert pkg.native.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF

    def test_fast_rand(self, pkg):
        vals = {pkg.native.fast_rand() for _ in range(64)}
        assert len(vals) > 60
        assert all(pkg.native.LIB.tb_fast_rand_less_than(10) < 10 for _ in range(100))

    def test_block_pool_reuses(self, pkg):
        b = pkg.iobuf._NativeIOBuf()
        b.append(os.urandom(64_000))
        mid = pkg.iobuf.block_pool_stats()
        assert mid["live"] >= 8  # 64 KB over 8 KB blocks
        b.clear()
        after = pkg.iobuf.block_pool_stats()
        assert after["cached"] > mid["cached"]
        assert after["live"] == mid["live"]

    def test_region_allocator_exhaust_and_reuse(self, pkg):
        iob = pkg.iobuf
        slab = bytearray(4 * 1024)
        rid = iob.register_region(slab, 1024)
        assert rid >= 0
        assert iob.region_free_blocks(rid) == 4
        b = iob._NativeIOBuf()
        assert b.append_from_region(rid, b"x" * 3000)
        assert iob.region_free_blocks(rid) == 1
        c = iob._NativeIOBuf()
        assert not c.append_from_region(rid, b"y" * 2000)
        c.clear()
        b.clear()
        assert iob.region_free_blocks(rid) == 4  # release returned blocks
        d = iob._NativeIOBuf()
        assert d.append_from_region(rid, b"Z" * 10)
        assert b"Z" * 10 in bytes(slab)  # the region's data lives in the slab
        d.clear()

    def test_resource_pool_versioned_ids(self, pkg):
        pool = pkg.native.ResourcePool(16)
        rid1 = pool.get()
        assert pool.address(rid1) is not None
        assert pool.live == 1
        assert pool.return_(rid1)
        assert pool.address(rid1) is None  # stale after return
        assert not pool.return_(rid1)  # double-return rejected
        rid2 = pool.get()
        assert (rid2 & 0xFFFFFFFF) == (rid1 & 0xFFFFFFFF)
        assert rid2 != rid1
        assert pool.address(rid1) is None
        assert pool.address(rid2) is not None

    def test_monotonic_ns_advances(self, pkg):
        t1 = pkg.native.monotonic_ns()
        t2 = pkg.native.monotonic_ns()
        assert t2 >= t1 > 0


# -- tbus_std frames --------------------------------------------------------------


def _frame_cases():
    rng = np.random.default_rng(21)
    big = rng.bytes(40_000)  # past the external-block threshold (32 KiB)
    return [
        (None, b"", 0, 0, 0, b""),
        (None, rng.bytes(256), 7, 0, 0, b""),
        ("meta", rng.bytes(1000), (3 << 32) | 5, port_tbus.FLAG_RESPONSE, 1002, b""),
        ("meta", rng.bytes(300), 11, 0, 0, rng.bytes(77)),
        ("meta", big, 1 << 40, 0, 0, rng.bytes(33_000)),
        ("stream", rng.bytes(5000), 0, port_tbus.FLAG_STREAM, 0, b""),
    ]


def _metas(kind):
    if kind is None:
        return None, None
    if kind == "stream":
        return (port_tbus.Meta(stream_id=3, extra={"ft": "data"}),
                jax_tbus.Meta(stream_id=3, extra={"ft": "data"}))
    kw = dict(service="Echo", method="echo", log_id=9, timeout_ms=250)
    return port_tbus.Meta(**kw), jax_tbus.Meta(**kw)


@pytest.mark.parametrize("body_crc", [False, True])
def test_native_frames_are_the_jax_packages_and_the_plain_packers(body_crc):
    port_set_flag("tbus_body_crc", body_crc)
    jax_set_flag("tbus_body_crc", body_crc)
    try:
        for kind, payload, cid, flags, err, att in _frame_cases():
            pm, jm = _metas(kind)
            native = port_tbus.pack_frame_iobuf(pm, payload, cid, flags, err, att)
            assert isinstance(native, port_iobuf._NativeIOBuf)
            wire = native.to_bytes()
            assert wire == port_tbus.pack_frame_iobuf_plain(pm, payload, cid, flags, err,
                                                            att).to_bytes()
            assert wire == port_tbus.pack_frame(pm, payload, cid, flags, err, att)
            assert wire == jax_tbus.pack_frame_iobuf(jm, payload, cid, flags, err, att).to_bytes()
            assert wire == jax_tbus.pack_frame(jm, payload, cid, flags, err, att)
            assert bool(port_tbus._HDR.unpack_from(wire)[2] & port_tbus.FLAG_BODY_CRC) == body_crc
            # every cut reads the frame back
            for cut, chain in ((port_tbus.parse_frame_iobuf, port_iobuf._NativeIOBuf),
                               (port_tbus.parse_frame_iobuf_plain, port_iobuf._PyIOBuf),
                               (jax_tbus.parse_frame_iobuf, jax_iobuf._NativeIOBuf)):
                buf = chain()
                buf.append(wire + b"tail")
                frame, n = cut(buf)
                assert n == len(wire) and buf.to_bytes() == b"tail"
                assert frame.correlation_id == cid and frame.error_code == err
                assert frame.payload == payload and frame.attachment == att
    finally:
        port_set_flag("tbus_body_crc", False)
        jax_set_flag("tbus_body_crc", False)


def test_native_cut_refuses_what_the_plain_cut_refuses():
    wire = bytearray(port_tbus.pack_frame(port_tbus.Meta(service="s", method="m"), b"p" * 64, 1))
    wire[40] ^= 1  # inside the meta: the CRC no longer holds
    for chain in (port_iobuf._NativeIOBuf, port_iobuf._PyIOBuf):
        buf = chain()
        buf.append(bytes(wire))
        with pytest.raises(port_tbus.ParseError, match="crc"):
            port_tbus.parse_frame_iobuf(buf)
    half = port_tbus.pack_frame(None, b"q" * 100, 2)[:50]
    for chain in (port_iobuf._NativeIOBuf, port_iobuf._PyIOBuf):
        buf = chain()
        buf.append(half)
        assert port_tbus.parse_frame_iobuf(buf) == (None, 0)
        buf = chain()
        buf.append(port_tbus.pack_frame(None, b"q" * 100, 2))
        with pytest.raises(port_tbus.ParseError, match="exceeds limit"):
            port_tbus.parse_frame_iobuf(buf, max_total=64)
