"""The port's examples (ROADMAP A5: ``incubator_brpc_tpu_torch/examples``)
on the CPU, each beside the JAX package's ``examples/`` file of the same
name.

Each case runs the JAX example (``runpy.run_path``, as
``tests/test_examples.py`` does) and the port's (``runpy.run_module``, as
``python -m incubator_brpc_tpu_torch.examples.<name>``) with the same
arguments, and compares what they print line by line once ports, times,
counts, ids, thread names and device names are masked (``shape``), and
dictionaries are read as sets of items (``session_data_and_thread_local``'s
lines as a set: a race in both packages can print one line twice). The
port's device examples and device halves (``echo demo tpu``,
``link_performance``, ``tensor_echo_tpu``,
``parallel_echo``, ``partition_echo``) run with ``--device cpu`` over the
port's CPU device links, where the JAX package's run on its 8 virtual CPU
devices; where that changes a line (``parallel_echo``'s fused dispatch,
which the port's one device cannot form: ROADMAP A3c), the port's line is
checked on its own. Each port example is also run as a module in a process
of its own, which must exit 0 (``test_example_runs_as_a_module``).

Every server an example starts is stopped by the example; after each test
the port's host plane is shut down and no ``tbtorch-*`` thread is left.
Tolerance: none; every comparison is of strings.
"""

import os
import re
import runpy
import subprocess
import sys

import pytest

from tests.test_torch_observability import nothing_outlives_the_test  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]

# (case id, module name, the JAX example's argv, the port's extra argv)
CASES = [
    ("asynchronous_echo", "asynchronous_echo", [], []),
    ("cancel_echo", "cancel_echo", [], []),
    ("multi_threaded_echo", "multi_threaded_echo", [], []),
    ("cascade_echo", "cascade_echo", [], []),
    ("echo", "echo", ["demo"], []),
    ("echo_tpu", "echo", ["demo", "tpu"], CPU),
    ("link_performance", "link_performance", ["--seconds", "1"], CPU),
    ("naming_failover", "naming_failover", [], []),
    ("selective_echo", "selective_echo", [], []),
    ("dynamic_partition_echo", "dynamic_partition_echo", [], []),
    ("streaming_echo", "streaming_echo", [], []),
    ("backup_request", "backup_request", [], []),
    ("overload_and_breaker", "overload_and_breaker", [], []),
    ("session_data_and_thread_local", "session_data_and_thread_local", [], []),
    ("http_upload", "http_upload", [], []),
    ("tensor_echo_tpu", "tensor_echo_tpu", [], CPU),
    ("parallel_echo", "parallel_echo", [], CPU),
    ("partition_echo", "partition_echo", [], CPU),
    ("tls_echo", "tls_echo", [], []),
    ("multi_protocol", "multi_protocol", [], CPU),
    ("nshead_extension", "nshead_extension", [], CPU),
    ("ubrpc_compack", "ubrpc_compack", [], CPU),
    ("cache_clients", "cache_clients", [], []),
    ("rtmp_relay", "rtmp_relay", [], []),
]
MODULES = sorted({module for _case, module, _a, _b in CASES})

# printed from another thread while the example winds down: present or not
RACY = {"[server] stream closed"}
# compared as sets of lines: where the first short connection's give-back
# loses the race to the second connection's borrow, either package makes a
# second session object and prints a second "destroyed" line
AS_SETS = {"session_data_and_thread_local"}

_DEVICE = re.compile(r"'(?:cpu|cuda:\d+|TFRT_CPU_\d+)'|CpuDevice\(id=\d+\)|TFRT_CPU_\d+"
                     r"|\bcuda:\d+\b|\bcpu\b")


def shape(line: str) -> str:
    """A printed line with what may differ between two runs masked."""
    line = _DEVICE.sub("DEV", line)
    line = re.sub(r"worker=\S+", "worker=W", line)
    line = re.sub(r"\d+(?:,\d{3})*(?:\.\d+)?", "N", line)
    return re.sub(r"\{([^{}]*)\}",
                  lambda m: "{" + ", ".join(sorted(m.group(1).split(", "))) + "}", line)


def run(capsys, monkeypatch, argv0, argv, fn):
    monkeypatch.setattr(sys, "argv", [argv0, *argv])
    fn()
    return [line for line in capsys.readouterr().out.splitlines() if line not in RACY]


@pytest.mark.parametrize("case,module,argv,port_extra", CASES, ids=[c[0] for c in CASES])
def test_example_prints_the_jax_examples_lines(case, module, argv, port_extra, capsys,
                                               monkeypatch):
    path = os.path.join(REPO, "examples", f"{module}.py")
    want = run(capsys, monkeypatch, path, argv,
               lambda: runpy.run_path(path, run_name="__main__"))
    got = run(capsys, monkeypatch, module, argv + port_extra,
              lambda: runpy.run_module(f"incubator_brpc_tpu_torch.examples.{module}",
                                       run_name="__main__"))
    assert got, "the port's example printed nothing"
    if case == "parallel_echo":
        # the JAX package fuses over its distinct virtual devices; the
        # port's links share the one device and take the host fan-out
        (jax_fused,) = [line for line in want if line.startswith("fused=")]
        (port_fused,) = [line for line in got if line.startswith("fused=")]
        assert jax_fused.startswith("fused=True merged=b'\\x02\\x03\\x04\\x02\\x03\\x04")
        merged = jax_fused.split()[1]
        assert port_fused.startswith(f"fused=False {merged}  (3 RPCs of the host fan-out")
        assert "ROADMAP A3c" in port_fused
        want = [line for line in want if line != jax_fused]
        got = [line for line in got if line != port_fused]
    if case in AS_SETS:
        assert set(map(shape, got)) == set(map(shape, want))
    else:
        assert sorted(map(shape, got)) == sorted(map(shape, want))


@pytest.mark.parametrize("module", MODULES)
def test_example_runs_as_a_module(module):
    argv = {"echo": ["demo", "tpu"], "link_performance": ["--seconds", "0.5"]}.get(module, [])
    if module in {m for _c, m, _a, extra in CASES if extra}:
        argv = argv + CPU
    proc = subprocess.run(
        [sys.executable, "-m", f"incubator_brpc_tpu_torch.examples.{module}", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip()


def test_device_examples_want_the_card_unless_asked():
    """Without ``--device cpu`` a device example asks for the card and,
    where PyTorch sees none, stops: nothing carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the example would run on it")
    from incubator_brpc_tpu_torch.examples import tensor_echo_tpu

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tensor_echo_tpu.main([])


def test_shape_masks_what_differs():
    assert shape("EchoServer listening on 127.0.0.1:40831 (portal: http://127.0.0.1:40831/status)") \
        == shape("EchoServer listening on 127.0.0.1:5 (portal: http://127.0.0.1:5/status)")
    assert shape("star fabric peers: ['TFRT_CPU_1', 'TFRT_CPU_2']") \
        == shape("star fabric peers: ['cpu', 'cpu']")
    assert shape("device: TFRT_CPU_0 window: 8") == shape("device: cpu window: 8")
    assert shape("both clusters up: {b'clusterB': 5, b'clusterA': 5}") \
        == shape("both clusters up: {b'clusterA': 4, b'clusterB': 6}")
    assert shape("host_cpus=8") != shape("host_DEVs=8")
    assert shape("response=b'hello'") != shape("response=b'hullo'")
