"""cache_clients — the ecosystem cache clients against in-process mock
servers (reference example/redis_c++ and example/memcache_c++): a
pipelined RESP client with AUTH, and the binary-protocol memcache client
with SASL PLAIN — both over the same Socket stack as every RPC.

Run:  python -m incubator_brpc_tpu_torch.examples.cache_clients

The port's copy of the JAX package's ``examples/cache_clients.py``, printing
its lines. Both clients and both mocks run on the host: no device takes part.
"""

from incubator_brpc_tpu_torch.protocol.memcache_binary import (
    MemcacheBinaryClient,
    MockMemcacheBinaryServer,
)
from incubator_brpc_tpu_torch.protocol.resp import MockRedisServer, RedisClient


def main() -> None:
    rsrv = MockRedisServer(password="hunter2")
    assert rsrv.start()
    r = RedisClient(f"127.0.0.1:{rsrv.port}", password="hunter2")
    r.execute("SET", "greeting", "hello")
    replies = r.pipeline([("GET", "greeting"), ("INCR", "visits"),
                          ("INCR", "visits")])
    print(f"redis: GET greeting={replies[0]!r}, visits={replies[2]}")
    r.close()
    rsrv.stop()

    msrv = MockMemcacheBinaryServer(password="s3cret")
    assert msrv.start()
    m = MemcacheBinaryClient(f"127.0.0.1:{msrv.port}", password="s3cret")
    m.set("k", b"binary-wire", flags=7)
    m.add("counter", b"41")
    m.incr("counter")
    m.incr("counter")
    print(f"memcache(binary): k={m.get('k')!r}, "
          f"counter={m.get('counter')!r}, version={m.version()}")
    m.close()
    msrv.stop()


if __name__ == "__main__":
    main()
