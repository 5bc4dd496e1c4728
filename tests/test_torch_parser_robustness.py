"""Every registered protocol parser of the port answers arbitrary bytes as
the JAX package's do: tests/test_parser_robustness.py's 2 registry cases,
each run on both packages through the ``pkg`` fixture, plus the outcome
of each parser on each input held equal across the packages.

The contract (the messenger's, ``transport/messenger.py``): a parser
returns (None, 0) (incomplete), a cut frame, or raises ``ParseError``
(not mine / resync) or ``FatalParseError`` (mine but unacceptable);
nothing else may escape the cut loop. Inputs are seeded pseudo-fuzz:
random bytes, and truncations, single-bit flips and splices of valid
frames. The stateful HTTP case is
``tests/test_torch_native_baidu.py::test_http_parse_conn_never_leaks_exceptions``.
Tolerance: none."""

import random
import types

import pytest

from incubator_brpc_tpu.protocol import baidu_std as jax_baidu
from incubator_brpc_tpu.protocol import tbus_std as jax_tbus
from incubator_brpc_tpu.protocol.registry import protocol_registry as jax_registry
from incubator_brpc_tpu_torch.protocol import baidu_std as port_baidu
from incubator_brpc_tpu_torch.protocol import tbus_std as port_tbus
from incubator_brpc_tpu_torch.protocol.registry import protocol_registry as port_registry

PKGS = {
    "jax": types.SimpleNamespace(tbus=jax_tbus, baidu=jax_baidu, registry=jax_registry),
    "torch": types.SimpleNamespace(tbus=port_tbus, baidu=port_baidu, registry=port_registry),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _valid_seeds(pkg):
    """A few valid frames across protocols, as corruption bases."""
    t = pkg.tbus
    seeds = [
        t.pack_frame(t.Meta(service="s", method="m"), b"payload" * 10, 3),
        b"POST /a/b HTTP/1.1\r\nHost: t\r\nContent-Length: 5\r\n\r\nhello",
        b"GET /x HTTP/1.1\r\n\r\n",
        pkg.baidu.pack_request(t.Meta(service="svc", method="mth"), b"body", 7),
    ]
    return [bytes(s) for s in seeds]


def _outcome(pkg, fn, data: bytes):
    """What one parser call did: the contract exception's name, or the
    bytes a cut consumed (None for no frame). Raises AssertionError when
    anything else escapes."""
    allowed = (pkg.tbus.ParseError, pkg.tbus.FatalParseError)
    try:
        out = fn(data)
    except allowed as e:
        return type(e).__name__
    except Exception as e:  # noqa: BLE001
        raise AssertionError(
            f"{fn.__module__}.{getattr(fn, '__name__', fn)} leaked "
            f"{type(e).__name__}: {e!r} on {data[:40]!r}..."
        ) from e
    if out is None:
        return None
    if isinstance(out, tuple):
        frame, consumed = out
        assert frame is None or consumed >= 0
        return ("frame" if frame is not None else "none", consumed)
    assert isinstance(out, int)  # parse_header's total
    return ("total", out)


def _drive(pkg, data: bytes):
    outcomes = []
    for proto in pkg.registry.ordered():
        if proto.parse is not None:
            outcomes.append((proto.name, "parse", _outcome(pkg, proto.parse, data)))
        if proto.parse_header is not None:
            outcomes.append((proto.name, "parse_header",
                             _outcome(pkg, proto.parse_header, data[:64])))
    return outcomes


def _random_inputs(seed):
    rng = random.Random(seed)
    for _ in range(40):
        n = rng.choice((1, 4, 16, 64, 300, 5000))
        yield bytes(rng.getrandbits(8) for _ in range(n))


def _corrupted_inputs(pkg, seed):
    rng = random.Random(1000 + seed)
    for base in _valid_seeds(pkg):
        for _ in range(30):
            data = bytearray(base)
            mode = rng.randrange(3)
            if mode == 0:  # truncate
                data = data[: rng.randrange(len(data))]
            elif mode == 1:  # flip one bit
                i = rng.randrange(len(data))
                data[i] ^= 1 << rng.randrange(8)
            else:  # splice garbage into the middle
                i = rng.randrange(len(data))
                data[i:i] = bytes(rng.getrandbits(8) for _ in range(rng.randrange(1, 9)))
            yield bytes(data)


@pytest.mark.parametrize("seed", range(8))
def test_random_bytes_never_leak_exceptions(pkg, seed):
    for data in _random_inputs(seed):
        _drive(pkg, data)


@pytest.mark.parametrize("seed", range(4))
def test_corrupted_valid_frames_never_leak_exceptions(pkg, seed):
    for data in _corrupted_inputs(pkg, seed):
        _drive(pkg, data)


def test_the_seeds_are_the_same_bytes_in_both_packages():
    assert _valid_seeds(PKGS["torch"]) == _valid_seeds(PKGS["jax"])


@pytest.mark.parametrize("seed", range(4))
def test_every_parser_answers_as_the_jax_packages_does(seed):
    jax, port = PKGS["jax"], PKGS["torch"]
    inputs = list(_random_inputs(seed)) + list(_corrupted_inputs(jax, seed))
    for data in inputs:
        assert _drive(port, data) == _drive(jax, data), data[:40]
