"""The port's ``bvar`` against the JAX package's: tests/test_bvar.py's 9
cases, each run on both packages through the ``pkg`` fixture.

``test_per_second_returns_float_fraction`` sleeps 50 ms only so that the
window's span is nonzero; it asserts the value's type, not a time.
Tolerance: the recorder's average within 1e-9, as the reference's."""

import threading
import time
import types

import pytest

from incubator_brpc_tpu import bvar as jax_bvar
from incubator_brpc_tpu.bvar import variable as jax_variable
from incubator_brpc_tpu.bvar import window as jax_window
from incubator_brpc_tpu_torch import bvar as port_bvar
from incubator_brpc_tpu_torch.bvar import variable as port_variable
from incubator_brpc_tpu_torch.bvar import window as port_window

PKGS = {
    "jax": types.SimpleNamespace(name="jax", bvar=jax_bvar, variable=jax_variable,
                                 window=jax_window),
    "torch": types.SimpleNamespace(name="torch", bvar=port_bvar, variable=port_variable,
                                   window=port_window),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def test_adder_multi_thread(pkg):
    a = pkg.bvar.Adder()
    n_threads, per_thread = 8, 10000

    def work():
        for _ in range(per_thread):
            a << 1

    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    [t.start() for t in ts]
    for t in ts:
        t.join(60)
        assert not t.is_alive()
    assert a.get_value() == n_threads * per_thread


def test_maxer_miner(pkg):
    m = pkg.bvar.Maxer()
    for v in (3, 9, 1):
        m << v
    assert m.get_value() == 9
    mn = pkg.bvar.Miner()
    for v in (3, 9, 1):
        mn << v
    assert mn.get_value() == 1


def test_int_recorder_average(pkg):
    r = pkg.bvar.IntRecorder()
    for v in range(1, 101):
        r << v
    assert abs(r.average() - 50.5) < 1e-9


def test_latency_recorder(pkg):
    lr = pkg.bvar.LatencyRecorder(window_size=2)
    for v in range(1000):
        lr << v
    assert lr.count() == 1000
    assert 0 <= lr.latency_percentile(0.5) <= 999
    assert lr.max_latency() == 999
    assert lr.latency() == sum(range(1000)) / 1000


def test_expose_registry_and_normalize(pkg):
    assert pkg.variable.normalize_name("FooBar::BazQps") == "foo_bar_baz_qps"
    name = f"test_expose_adder_xyz_{pkg.name}"
    a = pkg.bvar.Adder(name=name)
    a << 5
    dump = pkg.bvar.dump_exposed("test_expose_adder")
    assert dump.get(name) == "5"
    # duplicate exposure refused (reference variable.cpp behavior)
    b = pkg.bvar.Adder()
    assert not b.expose(name)
    assert a.hide()


def test_re_expose_drops_old_registry_entry(pkg):
    old, new = f"test_reexpose_old_{pkg.name}", f"test_reexpose_new_{pkg.name}"
    a = pkg.bvar.Adder(name=old)
    assert a.expose(new)
    assert pkg.bvar.dump_exposed(old) == {}
    assert new in pkg.bvar.dump_exposed(new)
    assert a.hide()
    assert pkg.bvar.dump_exposed(f"test_reexpose_new_{pkg.name}") == {}


def test_passive_status(pkg):
    x = {"v": 1}
    p = pkg.bvar.PassiveStatus(lambda: x["v"] * 2)
    assert p.get_value() == 2
    x["v"] = 21
    assert p.get_value() == 42


def test_adder_reset_rebase(pkg):
    a = pkg.bvar.Adder()
    for _ in range(10):
        a << 1
    assert a.reset() == 10
    assert a.get_value() == 0
    a << 5
    assert a.get_value() == 5
    assert a.reset() == 5


def test_per_second_returns_float_fraction(pkg):
    a = pkg.bvar.Adder()
    ps = pkg.window.PerSecond(a, window_size=10)
    a << 9
    ps._take_sample()  # seed one sample so the span is tiny but nonzero
    time.sleep(0.05)
    v = ps.get_value()
    assert isinstance(v, float)


def test_each_package_has_its_own_registry():
    name = "test_torch_bvar_registry_probe"
    a = port_bvar.Adder(name=name)
    try:
        assert jax_bvar.dump_exposed(name) == {}
        assert name in port_bvar.dump_exposed(name)
    finally:
        assert a.hide()
