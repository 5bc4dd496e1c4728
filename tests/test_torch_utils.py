"""The port's ``utils`` (the endpoint, status codes and the flag registry)
against the JAX package's: tests/test_utils.py's 8 cases, each run on both
packages through the ``pkg`` fixture, importing from each package's
``utils`` as the JAX suite does.

The unresolvable-host case resolves nothing: both packages' resolver is
stubbed to fail, as a lookup of an ``.invalid`` name does, and each must
turn that into ``ValueError``. Tolerance: none."""

import socket
import types

import pytest

import incubator_brpc_tpu.utils as jax_utils
import incubator_brpc_tpu.utils.endpoint as jax_endpoint
from incubator_brpc_tpu.utils.flags import FlagRegistry as JaxFlagRegistry
import incubator_brpc_tpu_torch.utils as port_utils
import incubator_brpc_tpu_torch.utils.endpoint as port_endpoint
from incubator_brpc_tpu_torch.utils.flags import FlagRegistry as PortFlagRegistry

PKGS = {
    "jax": types.SimpleNamespace(utils=jax_utils, endpoint=jax_endpoint,
                                 FlagRegistry=JaxFlagRegistry),
    "torch": types.SimpleNamespace(utils=port_utils, endpoint=port_endpoint,
                                   FlagRegistry=PortFlagRegistry),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def test_endpoint_parse_v4(pkg):
    ep = pkg.utils.str2endpoint("127.0.0.1:8787")
    assert (ep.ip, ep.port) == ("127.0.0.1", 8787)
    assert not ep.is_device()


def test_endpoint_parse_v6_literal(pkg):
    ep = pkg.utils.str2endpoint("[::1]:80")
    assert ep.ip == "::1" and ep.port == 80


def test_endpoint_parse_device(pkg):
    ep = pkg.utils.str2endpoint("tpu://10.0.0.1:9000/d2.3")
    assert ep.is_device() and ep.device == (2, 3)
    assert "tpu://" in str(ep)


def test_endpoint_unresolvable_raises_valueerror(pkg, monkeypatch):
    def no_such_host(host):
        raise socket.gaierror(socket.EAI_NONAME, "Name or service not known")

    monkeypatch.setattr(pkg.endpoint._socket, "gethostbyname", no_such_host)
    with pytest.raises(ValueError):
        pkg.utils.str2endpoint("no-such-host-xyz.invalid:1")


def test_endpoints_are_the_same_values_in_both_packages():
    for text in ("127.0.0.1:8787", "[::1]:80", "tpu://10.0.0.1:9000/d2.3", "unix:///tmp/x.sock"):
        j, p = jax_utils.str2endpoint(text), port_utils.str2endpoint(text)
        assert (p.ip, p.port, p.device, str(p)) == (j.ip, j.port, j.device, str(j))


def test_status_and_berror(pkg):
    s = pkg.utils.Status.OK()
    assert s.ok() and bool(s)
    f = pkg.utils.Status(pkg.utils.ErrorCode.ERPCTIMEDOUT)
    assert not f.ok()
    assert "timed out" in f.error_str().lower()


def test_flags_validator_gate(pkg):
    reg = pkg.FlagRegistry()
    reg.define("x", 5, "test", validator=lambda v: v > 0)
    reg.define("y", "a", "no validator")
    assert reg.get("x") == 5
    assert reg.set("x", 7) and reg.get("x") == 7
    assert not reg.set("x", -1) and reg.get("x") == 7
    reg.set_unchecked("y", "b")
    assert reg.get("y") == "b"


def test_flags_non_reloadable_rejected(pkg):
    reg = pkg.FlagRegistry()
    reg.define("z", 1, "non-reloadable")
    assert not reg.set("z", 2)
    assert reg.get("z") == 1
    reg.set_unchecked("z", 3)  # internal writes stay possible
    assert reg.get("z") == 3


def test_errno_transport_block_mirrors_reference(pkg):
    E = pkg.utils.ErrorCode
    assert E.ETRANSPORT == 3001
    assert E.ETRANSPORTCM == 3002
    assert E.ECLOSE == 2005
    assert E.ETERMINATED == 4001


def test_the_utils_packages_export_the_same_names():
    assert set(jax_utils.__all__) <= set(port_utils.__all__)
