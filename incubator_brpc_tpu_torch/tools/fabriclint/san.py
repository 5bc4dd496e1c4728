"""Sanitizer harness for the port's native host runtime.

Builds ASan+UBSan and TSan variants of the port's host library from
``csrc/host`` with g++ (the flags of ``src/Makefile``'s ``asan`` and
``tsan`` targets) into ``incubator_brpc_tpu_torch/_build/``, points the
port's loader at them through ``TBTORCH_HOST_LIB``, preloads the matching
runtime into the interpreter, and runs:

- **ASan+UBSan**: the port's native subset (tests/test_torch_native.py,
  tests/test_torch_native_plane.py, tests/test_torch_native_baidu.py),
  the port's cases only: heap errors and UB (UBSan findings are fatal
  through -fno-sanitize-recover).
- **TSan**: the telemetry ring's multi-producer stress, the work-stealing
  deque's steal storm, and the scheduler's schedule/unschedule storm
  racing stop, at a reduced burn. Only the instrumented C++ is tracked;
  the uninstrumented interpreter is invisible to TSan, so reports are
  races of csrc/host, not Python noise.

The tests run with ``--noconftest``: the port's cases need nothing of the
suite's conftest (which imports JAX), so the harness runs where JAX is not
installed.

Support is probed, not assumed: no g++, no sanitizer runtime, or a runtime
that cannot be preloaded into Python makes a run SKIP with a ``[skip]``
line (exit 0), as the tier-1 tests' probe-gated skip does (``chip_smoke.py
--sanitizers`` probes first and exits non-zero instead). A failure in a
supported environment exits 1.

Suppressions: ``tsan.supp`` beside this file carries ONE justified entry,
the glibc ``_dl_deallocate_tls`` TLS-teardown class, whose futex
synchronization lives in uninstrumented libc (full rationale in the
file). Every report in instrumented code gets fixed, not suppressed.

Usage::

    python -m incubator_brpc_tpu_torch.tools.fabriclint.san            # both
    python -m incubator_brpc_tpu_torch.tools.fabriclint.san --asan     # ASan+UBSan only
    python -m incubator_brpc_tpu_torch.tools.fabriclint.san --tsan     # TSan only
    python -m incubator_brpc_tpu_torch.tools.fabriclint.san --probe    # report support
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Optional, Tuple

from incubator_brpc_tpu_torch.tools.fabriclint import PKG_DIR, REPO_ROOT

HOST_DIR = os.path.join(PKG_DIR, "csrc", "host")
SOURCES = (
    os.path.join(HOST_DIR, "tbutil", "tbutil.cc"),
    os.path.join(HOST_DIR, "tbnet", "tbnet.cc"),
)
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ASAN_SO = os.path.join(BUILD_DIR, "libtbtorch_host_asan.so")
TSAN_SO = os.path.join(BUILD_DIR, "libtbtorch_host_tsan.so")
TSAN_SUPP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tsan.supp")

# src/Makefile's ASAN_FLAGS and TSAN_FLAGS (-O1: honest stacks without
# optimizing stores away), then its LDFLAGS and LIBS
_COMMON = ("-O1", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
FLAGS = {
    "asan": _COMMON + (
        "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
        "-fno-omit-frame-pointer",
    ),
    "tsan": _COMMON + ("-fsanitize=thread",),
}
LDFLAGS = ("-shared", "-pthread")
LIBS = ("-lz",)

ASAN_TESTS = [
    "tests/test_torch_native.py",
    "tests/test_torch_native_plane.py",
    "tests/test_torch_native_baidu.py",
]
TSAN_TESTS = [
    # the lock-free telemetry ring under multi-producer fire, including
    # the multi-reactor (4-ring) parametrization
    "tests/test_torch_native_plane.py::TestTelemetryRingStress",
    # the Chase-Lev deque: a steal storm racing owner push/pop and stop
    "tests/test_torch_native_plane.py::TestWorkStealingDequeStress",
    # the scheduler: worker pool + timer thread schedule/unschedule storm
    # racing stop
    "tests/test_torch_runtime.py::TestSchedulerContentionStress",
]

_PROBE_SRC = 'extern "C" int fabriclint_probe(void) { return 7; }\n'


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def _runtime_of(cxx: str, lib: str) -> Optional[str]:
    """Resolve the preloadable sanitizer runtime (libasan.so.N...)."""

    try:
        out = subprocess.run(
            [cxx, f"-print-file-name={lib}"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    if not out or out == lib:
        return None
    real = os.path.realpath(out)
    return real if os.path.exists(real) else None


def probe(kind: str) -> Tuple[bool, str]:
    """(supported, detail): can this toolchain build a ``kind``-sanitized
    .so AND preload its runtime into a fresh interpreter?"""

    cxx = _cxx()
    if cxx is None:
        return False, "no C++ compiler on PATH"
    flag = {"asan": "address", "tsan": "thread"}[kind]
    rt = _runtime_of(cxx, {"asan": "libasan.so", "tsan": "libtsan.so"}[kind])
    if rt is None:
        return False, f"lib{flag[:1]}san runtime not found"
    with tempfile.TemporaryDirectory(prefix="fabriclint-san-") as td:
        src = os.path.join(td, "probe.cc")
        so = os.path.join(td, "probe.so")
        with open(src, "w") as fh:
            fh.write(_PROBE_SRC)
        try:
            rc = subprocess.run(
                [cxx, "-shared", "-fPIC", f"-fsanitize={flag}", "-o", so, src],
                capture_output=True, timeout=120,
            ).returncode
        except (OSError, subprocess.SubprocessError):
            return False, "sanitized compile failed"
        if rc != 0 or not os.path.exists(so):
            return False, "sanitized compile failed"
        env = dict(os.environ, LD_PRELOAD=rt)
        env.setdefault("ASAN_OPTIONS", "detect_leaks=0")
        try:
            r = subprocess.run(
                [
                    sys.executable, "-c",
                    "import ctypes, sys;"
                    f"l = ctypes.CDLL({so!r});"
                    "sys.exit(0 if l.fabriclint_probe() == 7 else 3)",
                ],
                capture_output=True, timeout=120, env=env,
            )
        except (OSError, subprocess.SubprocessError):
            return False, "python-under-sanitizer probe failed"
        if r.returncode != 0:
            return False, "sanitizer runtime cannot preload into python"
    return True, rt


def build(kind: str) -> bool:
    """Compile the ``kind``-sanitized host library into ``_build/``."""

    out = {"asan": ASAN_SO, "tsan": TSAN_SO}[kind]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_cxx() or "g++", *FLAGS[kind], *LDFLAGS, "-o", tmp, *SOURCES, *LIBS]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    except (OSError, subprocess.SubprocessError) as e:
        sys.stderr.write(f"{' '.join(cmd)}\n{e}\n")
        return False
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-2000:] + r.stderr[-2000:])
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False
    os.replace(tmp, out)
    return True


def _pytest(args, env) -> Tuple[int, str]:
    cmd = [
        sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
        "--noconftest", "-k", "not jax",
    ]
    cmd += args
    full_env = dict(os.environ)
    full_env.update(env)
    timeout_s = int(os.environ.get("FABRICLINT_SAN_TIMEOUT", "1800"))
    try:
        r = subprocess.run(
            cmd, capture_output=True, text=True, cwd=REPO_ROOT,
            env=full_env, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired as e:
        # a hung sanitized run (a deadlock TSan can see is exactly the
        # class this harness hunts) is a FAILURE, not a crash
        out = (e.stdout or b"").decode("utf-8", "replace") if isinstance(
            e.stdout, bytes
        ) else (e.stdout or "")
        return 124, out + f"\n[san] run exceeded {timeout_s}s and was killed"
    return r.returncode, r.stdout + r.stderr


def _last_line(out: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return lines[-1].strip() if lines else "(no output)"


def _preflight_native(env) -> Optional[str]:
    """The sanitized .so must load: a silent pure-Python fallback would
    'pass' the whole run without testing anything."""

    full_env = dict(os.environ)
    full_env.update(env)
    r = subprocess.run(
        [
            sys.executable, "-c",
            "from incubator_brpc_tpu_torch import native; import sys; "
            "sys.exit(0 if native.NATIVE_AVAILABLE and "
            "native.BUILD_INFO.get('path') == native._LIB_OVERRIDE else 4)",
        ],
        capture_output=True, text=True, cwd=REPO_ROOT, env=full_env,
        timeout=300,
    )
    if r.returncode != 0:
        return f"sanitized library did not load: {r.stderr[-500:]}"
    return None


def run_asan() -> int:
    ok, detail = probe("asan")
    if not ok:
        print(f"[skip] asan: {detail}")
        return 0
    if not build("asan"):
        print("[FAIL] asan: build failed")
        return 1
    env = {
        "TBTORCH_HOST_LIB": ASAN_SO,
        "LD_PRELOAD": detail,
        # protect_shadow_gap=0: the CUDA driver maps device memory into the
        # range ASan would otherwise reserve, where PyTorch probes a card
        "ASAN_OPTIONS": (
            "detect_leaks=0:abort_on_error=1:verify_asan_link_order=0:"
            "protect_shadow_gap=0"
        ),
        "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1",
    }
    err = _preflight_native(env)
    if err:
        print(f"[FAIL] asan: {err}")
        return 1
    rc, out = _pytest(ASAN_TESTS + ["-m", "not slow"], env)
    bad = (
        rc != 0
        or "ERROR: AddressSanitizer" in out
        or "runtime error:" in out
    )
    tail = "\n".join(out.splitlines()[-15:])
    if bad:
        print(f"[FAIL] asan/ubsan native subset:\n{tail}")
        return 1
    print(f"[ok] asan/ubsan native subset: {_last_line(out)}")
    return 0


def run_tsan() -> int:
    ok, detail = probe("tsan")
    if not ok:
        print(f"[skip] tsan: {detail}")
        return 0
    if not build("tsan"):
        print("[FAIL] tsan: build failed")
        return 1
    env = {
        "TBTORCH_HOST_LIB": TSAN_SO,
        "LD_PRELOAD": detail,
        # exitcode=66 turns any report into a hard failure even with the
        # default halt_on_error=0 (all reports print, then the run fails)
        "TSAN_OPTIONS": f"exitcode=66:suppressions={TSAN_SUPP}",
        # reduced burn: TSan costs ~20x; 4 x 400 still crosses every
        # producer/consumer/ring-full interleaving the full test does
        "TBNET_STRESS_THREADS": "4",
        "TBNET_STRESS_N": "400",
        "SCHED_STRESS_THREADS": "4",
        "SCHED_STRESS_N": "200",
        "WSQ_STRESS_THREADS": "4",
        "WSQ_STRESS_N": "4000",
    }
    err = _preflight_native(env)
    if err:
        print(f"[FAIL] tsan: {err}")
        return 1
    rc, out = _pytest(TSAN_TESTS, env)
    bad = rc != 0 or "WARNING: ThreadSanitizer" in out
    tail = "\n".join(out.splitlines()[-15:])
    if bad:
        print(f"[FAIL] tsan ring + deque + scheduler stress:\n{tail}")
        return 1
    print(f"[ok] tsan ring + deque + scheduler stress: {_last_line(out)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fabriclint.san")
    ap.add_argument("--asan", action="store_true")
    ap.add_argument("--tsan", action="store_true")
    ap.add_argument(
        "--probe", action="store_true", help="report support and exit"
    )
    args = ap.parse_args(argv)
    if args.probe:
        for kind in ("asan", "tsan"):
            ok, detail = probe(kind)
            print(f"{kind}: {'supported' if ok else 'UNSUPPORTED'} ({detail})")
        return 0
    run_both = not (args.asan or args.tsan)
    rc = 0
    if args.asan or run_both:
        rc |= run_asan()
    if args.tsan or run_both:
        rc |= run_tsan()
    return rc


if __name__ == "__main__":
    sys.exit(main())
