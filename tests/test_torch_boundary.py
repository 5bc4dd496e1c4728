"""The port's import boundary: ``incubator_brpc_tpu_torch`` and
``chip_smoke.py`` import neither ``jax`` nor anything of the JAX package
``incubator_brpc_tpu``; importing any module starts no kernel build (the
host runtime's library, ``native.py``, loads at import, built once by g++
into the port's ``_build/``); and a process of the port alone that served
a native-plane echo has mapped the port's host library and never the JAX
package's ``src/build/libtbutil.so``. The scans cover the port's tools
(``tools/``), its examples (``examples/``) and its entry points
(``graft_entry.py``), none of which reaches the repository root's
``tools/`` or ``examples/`` through ``sys.path``."""

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "incubator_brpc_tpu_torch"

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax\b|jaxlib\b|incubator_brpc_tpu(?:\.|\s|$))", re.M
)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_every_module_imports_without_jax_or_the_jax_package():
    modules = list(_port_modules())
    assert len(modules) >= 20
    probe = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'incubator_brpc_tpu' or m.startswith('incubator_brpc_tpu.'))\n"
        "from incubator_brpc_tpu_torch.ops import kernels\n"
        "print(json.dumps({'bad': bad, 'built': kernels._lib is not None}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"bad": [], "built": False}


def test_a_port_process_maps_only_the_ports_host_library():
    probe = (
        "import json\n"
        "import incubator_brpc_tpu_torch.rpc as rpc\n"
        "from incubator_brpc_tpu_torch import native\n"
        "srv = rpc.Server(rpc.ServerOptions(native_plane=True, device='cpu'))\n"
        "srv.add_service('svc', {'echo': rpc.native_echo})\n"
        "assert srv.start(0) and srv._native_plane is not None\n"
        "ch = rpc.Channel()\n"
        "assert ch.init(f'127.0.0.1:{srv.port}', options=rpc.ChannelOptions(native_plane=True))\n"
        "c = ch.call_method('svc', 'echo', b'boundary')\n"
        "assert c.ok() and c.response_payload == b'boundary'\n"
        "maps = open('/proc/self/maps').read()\n"
        "libs = sorted({l.split()[-1] for l in maps.splitlines() if '.so' in l.split()[-1]})\n"
        "srv.stop(); srv.join(); rpc.shutdown_host_plane()\n"
        "print(json.dumps({'libs': libs, 'own': str(native.library_path())}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["own"] in result["libs"]
    assert str(PORT / "_build") in result["own"]
    assert not [lib for lib in result["libs"] if "libtbutil" in lib or "src/build" in lib]


def test_no_source_names_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [
        f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
        for f in files
        for m in _FORBIDDEN.finditer(f.read_text())
    ]
    assert offenders == []


def test_scan_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import incubator_brpc_tpu",
                 "from incubator_brpc_tpu.ops import framing", "    import jax.numpy as jnp"):
        assert _FORBIDDEN.search(line), line
    for line in ("import incubator_brpc_tpu_torch", "from incubator_brpc_tpu_torch.ops import x",
                 "# import jax is not used"):
        assert not _FORBIDDEN.search(line), line


A5 = {
    "incubator_brpc_tpu_torch.graft_entry",
    *(f"incubator_brpc_tpu_torch.tools.{m}"
      for m in ("rpc_press", "rpc_view", "rpc_replay", "parallel_http")),
    *(f"incubator_brpc_tpu_torch.examples.{m}"
      for m in ("asynchronous_echo", "cancel_echo", "multi_threaded_echo", "cascade_echo", "echo",
                "link_performance", "naming_failover", "selective_echo", "dynamic_partition_echo",
                "streaming_echo", "backup_request", "overload_and_breaker",
                "session_data_and_thread_local", "http_upload", "tensor_echo_tpu",
                "parallel_echo", "partition_echo")),
}


# the port's fabriclint (A13a), a package of its own under tools/
A13A = {
    "incubator_brpc_tpu_torch.tools.fabriclint",
    *(f"incubator_brpc_tpu_torch.tools.fabriclint.{m}"
      for m in ("cdecl", "ffi_check", "errcheck", "lifetime", "hotpath", "registry_lint", "san",
                "__main__")),
}


def _module_path(module):
    path = ROOT / module.replace(".", "/")
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


def test_the_tools_examples_and_entry_are_inside_the_scans():
    """Every module of the three places is one the import probe imports
    and the source scan reads, and none puts the repository root (the JAX
    package's tools and examples) on ``sys.path``."""
    assert A5 | A13A <= set(_port_modules())
    for module in sorted(A5 | A13A):
        text = _module_path(module).read_text()
        assert not _FORBIDDEN.search(text), module
        assert "sys.path" not in text, module
        assert not re.search(r"^\s*(?:import|from)\s+(?:tools|examples)\b", text, re.M), module
