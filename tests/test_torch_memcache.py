"""The memcache text-protocol client (``protocol/memcache.py``) of the port on
the CPU, held against the JAX package's:

- ``tests/test_auth_dynpart_memcache.py``'s ``TestMemcache`` (4 cases) on
  both packages (store and retrieve, incr/decr, get_multi and version, one
  client shared by four threads);
- the bytes: seeded store, get and line commands pack alike in both
  packages, the key check refuses the same keys, and each package's reply
  parser reads seeded replies alike at every prefix length;
- interop over TCP both ways: each package's client against the other's
  mock server.

After each test the port's host plane is shut down and no ``tbtorch-*``
thread is left. Tolerance: none; every comparison is of bytes, integers or
strings."""

from __future__ import annotations

import threading
import types

import numpy as np
import pytest

import incubator_brpc_tpu_torch.rpc as port_rpc
from incubator_brpc_tpu.protocol import memcache as jax_memcache
from incubator_brpc_tpu_torch.protocol import memcache as port_memcache
from incubator_brpc_tpu_torch.runtime.device_butex import shutdown_watchers
from incubator_brpc_tpu_torch.runtime.timer_thread import shutdown_global_timer_thread

PKGS = {
    "jax": types.SimpleNamespace(name="jax", memcache=jax_memcache),
    "torch": types.SimpleNamespace(name="torch", memcache=port_memcache),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def no_port_thread_outlives_the_test():
    yield
    port_rpc.shutdown_host_plane()
    assert shutdown_watchers(timeout=60)
    shutdown_global_timer_thread()
    left = [t.name for t in threading.enumerate() if t.name.startswith("tbtorch-")]
    assert left == []


# -- TestMemcache on both packages ---------------------------------------------


class TestMemcache:
    @pytest.fixture
    def pair(self, pkg):
        server = pkg.memcache.MockMemcacheServer()
        assert server.start()
        client = pkg.memcache.MemcacheClient(f"127.0.0.1:{server.port}")
        yield server, client
        client.close()
        server.stop()

    def test_store_and_retrieve(self, pair):
        _, c = pair
        assert c.set("k", b"v1", flags=7)
        assert c.get("k") == b"v1"
        assert c.get("missing") is None
        assert not c.add("k", b"v2")  # exists
        assert c.replace("k", b"v2")
        assert c.get("k") == b"v2"
        assert c.delete("k")
        assert not c.delete("k")

    def test_incr_decr(self, pair):
        _, c = pair
        assert c.set("n", b"10")
        assert c.incr("n", 5) == 15
        assert c.decr("n", 3) == 12
        assert c.incr("missing") == "NOT_FOUND"

    def test_get_multi_and_version(self, pair):
        _, c = pair
        c.set("a", b"1")
        c.set("b", b"2")
        assert c.get_multi("a", "b", "zz") == {"a": b"1", "b": b"2"}
        assert "VERSION" in c.version()

    def test_concurrent_clients(self, pair):
        _, c = pair
        errs = []

        def worker(i):
            try:
                for j in range(30):
                    key = f"w{i}"
                    assert c.set(key, b"%d" % j)
                    assert c.get(key) is not None
            except Exception as e:  # pragma: no cover
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs


# -- the bytes -------------------------------------------------------------------


def _key(rng):
    return rng.integers(33, 127, int(rng.integers(1, 40)), dtype=np.uint8).tobytes().decode()


def test_commands_identical_across_packages():
    rng = np.random.default_rng(28)
    for _ in range(60):
        key = _key(rng)
        value = rng.integers(0, 256, int(rng.choice([0, 1, 100, 3000])), dtype=np.uint8).tobytes()
        flags, exptime = int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 31))
        for verb in ("set", "add", "replace"):
            assert port_memcache.pack_store(verb, key, value, flags, exptime) == \
                jax_memcache.pack_store(verb, key, value, flags, exptime)
        keys = [_key(rng) for _ in range(int(rng.integers(1, 5)))]
        assert port_memcache.pack_get(*keys) == jax_memcache.pack_get(*keys)
        delta = int(rng.integers(0, 1 << 40))
        for verb, words in (("delete", (key,)), ("incr", (key, delta)), ("decr", (key, delta))):
            assert port_memcache.pack_line(verb, *words) == jax_memcache.pack_line(verb, *words)
    assert port_memcache.pack_line("version", key_first=False) == \
        jax_memcache.pack_line("version", key_first=False)
    for bad in ("", "a b", "x" * 251, "tab\there", "del\x7f", "nl\r\n"):
        for m in (jax_memcache, port_memcache):
            with pytest.raises(m.MemcacheError):
                m.pack_get(bad)


def test_replies_parse_alike_across_packages():
    rng = np.random.default_rng(29)
    lines = [b"STORED", b"NOT_STORED", b"DELETED", b"NOT_FOUND", b"ERROR",
             b"VERSION incubator_brpc_tpu-mock", b"12345", b"0"]
    for _ in range(40):
        if rng.integers(0, 2):
            wire = bytes(lines[int(rng.integers(0, len(lines)))]) + b"\r\n"
        else:
            parts = []
            for _ in range(int(rng.integers(0, 4))):
                value = rng.integers(0, 256, int(rng.integers(0, 60)), dtype=np.uint8).tobytes()
                parts.append(b"VALUE %s %d %d\r\n%s\r\n" % (
                    _key(rng).encode(), int(rng.integers(0, 1 << 16)), len(value), value))
            wire = b"".join(parts) + b"END\r\n"
        for cut in range(len(wire) + 1):
            assert port_memcache.parse_reply(wire[:cut]) == jax_memcache.parse_reply(wire[:cut])
        assert port_memcache.parse_reply(wire)[1] == len(wire)
    for m in (jax_memcache, port_memcache):
        with pytest.raises(m.MemcacheError):
            m.parse_reply(b"VALUE k 0 1\r\nx\r\nBOGUS\r\n")


# -- interop over TCP both ways ------------------------------------------------


@pytest.mark.parametrize("client,srv_pkg", [("torch", "jax"), ("jax", "torch")],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_interop_both_ways(client, srv_pkg):
    cp, sp = PKGS[client], PKGS[srv_pkg]
    srv = sp.memcache.MockMemcacheServer()
    assert srv.start()
    try:
        c = cp.memcache.MemcacheClient(f"127.0.0.1:{srv.port}")
        rng = np.random.default_rng(30)
        values = {f"k{i}": rng.integers(0, 256, 200, dtype=np.uint8).tobytes() for i in range(6)}
        for k, v in values.items():
            assert c.set(k, v, flags=5)
        assert c.get_multi(*values, "nope") == values
        assert not c.add("k0", b"x") and c.replace("k0", b"y") and c.get("k0") == b"y"
        assert c.set("n", b"7") and c.incr("n", 5) == 12 and c.decr("n", 20) == 0
        assert c.delete("k1") and not c.delete("k1")
        assert c.version() == "VERSION incubator_brpc_tpu-mock"
        c.close()
    finally:
        srv.stop()
