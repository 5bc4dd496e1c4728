"""The port's fabriclint (``incubator_brpc_tpu_torch/tools/fabriclint``)
against the JAX package's (``tools/fabriclint``): fabriclint's part of
tests/test_static_analysis.py, run on both tools.

- **The port is clean**: every pass of the port's tool over the port's
  package, its C++ headers under ``csrc/host`` and its ``SIGNATURES``
  reports no violation (the lint gate of the port).
- **Header parity**: the port's parser reads the port's headers into the
  same declarations, with the same canonical scalars, as the JAX tool
  reads from ``src/``; the two copies of the runtime are one ABI.
- **Mutations**: each seeded drift of tbnet.h (a width, a signedness, a
  dropped argument, a callback or struct layout, a removed or a new
  export) is applied to each tool's own copy of the header and flips
  that tool red with the same rule, the port's tool reading the mutated
  ``csrc/host`` header against the port's ``SIGNATURES``.
- **The rule fixtures** (annotations, hot-path purity, keep-alives,
  error checks, the flag and bvar registries) run on both tools over the
  same synthetic sources, the package name in each source the tool's.
- **Hot-path markers**: the functions the port marks ``hotpath`` are the
  JAX package's, module for module.
- **The FFI count** the README quotes is ``len(native.SIGNATURES)``.

The sanitizer cases stay slow and probe-gated, as in the reference.
Tolerance: none; everything here is exact."""

from __future__ import annotations

import json
import os
import re
import types

import pytest

import tools.fabriclint as jax_lint
from tools.fabriclint import cdecl as jax_cdecl
from tools.fabriclint import errcheck as jax_errcheck
from tools.fabriclint import ffi_check as jax_ffi
from tools.fabriclint import hotpath as jax_hotpath
from tools.fabriclint import lifetime as jax_lifetime
from tools.fabriclint import registry_lint as jax_registry
import incubator_brpc_tpu_torch.tools.fabriclint as port_lint
from incubator_brpc_tpu_torch import native as port_native
from incubator_brpc_tpu_torch.tools.fabriclint import cdecl as port_cdecl
from incubator_brpc_tpu_torch.tools.fabriclint import errcheck as port_errcheck
from incubator_brpc_tpu_torch.tools.fabriclint import ffi_check as port_ffi
from incubator_brpc_tpu_torch.tools.fabriclint import hotpath as port_hotpath
from incubator_brpc_tpu_torch.tools.fabriclint import lifetime as port_lifetime
from incubator_brpc_tpu_torch.tools.fabriclint import registry_lint as port_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "incubator_brpc_tpu_torch")
JAX_PKG = os.path.join(REPO, "incubator_brpc_tpu")

TOOLS = {
    "jax": types.SimpleNamespace(
        name="jax", package="incubator_brpc_tpu", lint=jax_lint, cdecl=jax_cdecl,
        ffi=jax_ffi, hotpath=jax_hotpath, lifetime=jax_lifetime, errcheck=jax_errcheck,
        registry=jax_registry,
        tbnet_h=os.path.join(REPO, "src", "tbnet", "tbnet.h"),
        native_module="incubator_brpc_tpu.native",
    ),
    "torch": types.SimpleNamespace(
        name="torch", package="incubator_brpc_tpu_torch", lint=port_lint, cdecl=port_cdecl,
        ffi=port_ffi, hotpath=port_hotpath, lifetime=port_lifetime, errcheck=port_errcheck,
        registry=port_registry,
        tbnet_h=port_lint.PORT.headers[1],
        native_module="incubator_brpc_tpu_torch.native",
    ),
}


@pytest.fixture(params=["jax", "torch"])
def tool(request):
    return TOOLS[request.param]


def _fmt(violations):
    return "\n".join(str(v) for v in violations)


# ---------------------------------------------------------------------------
# 1. the port is clean (the port's lint gate)
# ---------------------------------------------------------------------------


class TestRepoIsClean:
    def test_ffi_signatures_match_headers(self):
        vs = port_ffi.check()
        assert not vs, _fmt(vs)

    def test_hotpath_functions_are_pure(self):
        vs = port_hotpath.check()
        assert not vs, _fmt(vs)

    def test_flag_and_bvar_registries(self):
        vs = port_registry.check()
        assert not vs, _fmt(vs)

    def test_ffi_callbacks_have_keepalives(self):
        vs = port_lifetime.check()
        assert not vs, _fmt(vs)

    def test_tb_error_codes_checked_or_voided(self):
        vs = port_errcheck.check()
        assert not vs, _fmt(vs)

    def test_run_all_aggregate(self):
        vs = port_lint.run_all()
        assert not vs, _fmt(vs)

    def test_the_port_scans_its_own_tree(self):
        files = port_lint.iter_py_files()
        assert files and all(f.startswith(PORT_PKG + os.sep) for f in files)
        tests = set(port_lint.iter_py_files(include_tests=True)) - set(files)
        assert tests and all(os.path.basename(t).startswith("test_torch_") for t in tests)
        assert port_lint.PORT.headers == (
            os.path.join(PORT_PKG, "csrc", "host", "tbutil", "tbutil.h"),
            os.path.join(PORT_PKG, "csrc", "host", "tbnet", "tbnet.h"),
        )


# ---------------------------------------------------------------------------
# 2a. the header parser models the real headers completely, and the port's
# headers are the JAX package's ABI
# ---------------------------------------------------------------------------


def _canon(t):
    return (t.kind, t.bits, t.signed_, t.pointee)


def _header_model(merged):
    return {
        "funcs": {n: (_canon(f.ret), [_canon(a) for a in f.args]) for n, f in merged.funcs.items()},
        "funcptrs": {n: (_canon(f.ret), [_canon(a) for a in f.args])
                     for n, f in merged.funcptrs.items()},
        "structs": {n: ([(f.name, f.bits, f.signed_, f.offset_bits, f.is_ptr) for f in s.fields],
                        s.size_bits) for n, s in merged.structs.items()},
        "opaques": sorted(merged.opaques),
    }


class TestHeaderParser:
    @pytest.fixture()
    def merged(self, tool):
        return tool.ffi.parse_repo_headers()

    def test_every_declaration_parsed(self, merged):
        assert merged.unparsed == []

    def test_function_count_matches_sigs(self, tool, merged):
        native = __import__(tool.native_module, fromlist=["SIGNATURES"])
        assert set(merged.funcs) == set(native.SIGNATURES)

    def test_telemetry_record_is_64_bytes(self, merged):
        assert merged.structs["tb_telemetry_record"].size_bits == 64 * 8

    def test_callback_typedefs_present(self, merged):
        assert {
            "tb_frame_fn",
            "tb_handoff_fn",
            "tb_closed_fn",
            "tb_native_fn",
            "tb_release_fn",
        } <= set(merged.funcptrs)

    def test_one_line_extern_c_declaration_still_parses(self, tool):
        src = (
            'extern "C" int tb_one_liner(int x);\n'
            'extern "C" {\n'
            "int tb_block_form(int y);\n"
            "}\n"
        )
        h = tool.cdecl.parse_header("/synthetic.h", text=src)
        assert set(h.funcs) == {"tb_one_liner", "tb_block_form"}
        assert h.unparsed == []

    def test_scalar_canonicalization(self, tool, merged):
        parse = tool.cdecl.parse_type
        t = parse("const char*", merged)
        assert t.kind == "ptr" and t.pointee == "char"
        t = parse("uint64_t", merged)
        assert (t.bits, t.signed_) == (64, False)
        t = parse("long", merged)
        assert (t.bits, t.signed_) == (64, True)
        assert parse("tb_iobuf*", merged).pointee == "opaque:tb_iobuf"

    def test_the_ports_headers_are_the_jax_packages_abi(self):
        port = _header_model(port_ffi.parse_repo_headers())
        jax = _header_model(jax_ffi.parse_repo_headers())
        assert len(port["funcs"]) == len(port_native.SIGNATURES)
        assert port == jax


# ---------------------------------------------------------------------------
# 2b. seeded mutations flip both FFI checkers red with the same rule
# ---------------------------------------------------------------------------


class TestFfiCheckerCatchesDrift:
    @pytest.fixture()
    def tbnet_text(self, tool):
        with open(tool.tbnet_h) as fh:
            return fh.read()

    def _check(self, tool, text, old, new):
        assert old in text, f"mutation anchor missing: {old!r}"
        return tool.ffi.check(tbnet_text=text.replace(old, new))

    def test_width_change_in_one_signature(self, tool, tbnet_text):
        vs = self._check(tool, tbnet_text, "const char* ip, int port)", "const char* ip, long port)")
        assert any(v.rule == "ffi-type" and "tb_server_listen" in v.message for v in vs), _fmt(vs)

    def test_width_change_in_new_reactor_export(self, tool, tbnet_text):
        vs = self._check(
            tool, tbnet_text,
            "int tb_server_reactor_stats(const tb_server* s, int reactor,",
            "int tb_server_reactor_stats(const tb_server* s, long reactor,",
        )
        assert any(v.rule == "ffi-type" and "tb_server_reactor_stats" in v.message
                   for v in vs), _fmt(vs)

    def test_width_change_in_auth_export(self, tool, tbnet_text):
        vs = self._check(
            tool, tbnet_text,
            "int tb_server_set_auth_tokens(tb_server* s, const char* blob,\n"
            "                              size_t blob_len);",
            "int tb_server_set_auth_tokens(tb_server* s, const char* blob,\n"
            "                              int blob_len);",
        )
        assert any(v.rule == "ffi-type" and "tb_server_set_auth_tokens" in v.message
                   for v in vs), _fmt(vs)

    def test_skewed_telemetry_record_layout(self, tool, tbnet_text):
        vs = self._check(
            tool, tbnet_text,
            "  uint64_t trace_id;\n  uint64_t span_id;\n} tb_telemetry_record;",
            "  uint32_t trace_id;\n  uint32_t span_id;\n} tb_telemetry_record;",
        )
        assert any(v.rule == "ffi-struct" and "tb_telemetry_record" in v.message
                   for v in vs), _fmt(vs)

    def test_skewed_scan_trace_out_param_flips_red(self, tool, tbnet_text):
        vs = self._check(
            tool, tbnet_text,
            "uint64_t* log_id_out, uint64_t* trace_id_out,",
            "uint64_t* log_id_out, uint32_t* trace_id_out,",
        )
        assert any(v.rule == "ffi-type" and "tb_scan_prpc_meta" in v.message
                   for v in vs), _fmt(vs)

    def test_auth_callback_layout_drift_flips_red(self, tool, tbnet_text):
        vs = self._check(
            tool, tbnet_text,
            "typedef int (*tb_auth_fn)(void* ud, const char* auth_data, size_t auth_len,\n"
            "                          const char* peer_ip, int peer_port);",
            "typedef int (*tb_auth_fn)(void* ud, const char* auth_data, size_t auth_len,\n"
            "                          const char* peer_ip);",
        )
        assert any(v.rule == "ffi-callback" for v in vs), _fmt(vs)

    def test_native_method_callback_layout_drift_flips_red(self, tool, tbnet_text):
        # tb_native_fn crosses the FFI as a void*: its CFUNCTYPE mirror
        # (NATIVE_METHOD_FN) is what holds the layout
        anchor = re.search(r"typedef int \(\*tb_native_fn\)\([^;]*size_t\* resp_len\);",
                           tbnet_text, re.S)
        assert anchor, "tb_native_fn typedef not found"
        old = anchor.group(0)
        vs = self._check(tool, tbnet_text, old, old.replace("size_t* resp_len", "int* resp_len"))
        assert any(v.rule == "ffi-callback" and "NATIVE_METHOD_FN" in v.message
                   for v in vs), _fmt(vs)

    def test_signedness_change(self, tool, tbnet_text):
        vs = self._check(tool, tbnet_text, "uint64_t tb_server_telemetry_dropped",
                         "int64_t tb_server_telemetry_dropped")
        assert any(
            v.rule == "ffi-type"
            and "tb_server_telemetry_dropped" in v.message
            and "signedness" in v.message
            for v in vs
        ), _fmt(vs)

    def test_dropped_argument(self, tool, tbnet_text):
        vs = self._check(
            tool, tbnet_text,
            "void tb_server_set_telemetry(tb_server* s, uint32_t capacity,\n"
            "                             uint32_t sample_every);",
            "void tb_server_set_telemetry(tb_server* s, uint32_t capacity);",
        )
        assert any(v.rule == "ffi-arity" for v in vs), _fmt(vs)

    def test_callback_layout_change(self, tool, tbnet_text):
        vs = self._check(tool, tbnet_text,
                         "uint32_t cid_lo,\n                            uint32_t cid_hi, uint32_t flags",
                         "uint64_t cid_lo,\n                            uint32_t cid_hi, uint32_t flags")
        assert any(v.rule == "ffi-callback" for v in vs), _fmt(vs)

    def test_struct_field_resize(self, tool, tbnet_text):
        vs = self._check(tool, tbnet_text, "uint32_t request_size;", "uint64_t request_size;")
        struct_vs = [v for v in vs if v.rule == "ffi-struct"]
        # the record is mirrored twice: the ctypes Structure and the numpy
        # drain dtype; both must scream
        assert any("TelemetryRecord" in v.message or "ctypes" in v.message
                   or "offset" in v.message for v in struct_vs), _fmt(vs)
        assert any("numpy" in v.message for v in struct_vs), _fmt(vs)

    def test_removed_declaration_is_ffi_missing(self, tool, tbnet_text):
        vs = self._check(tool, tbnet_text, "int tb_server_port(const tb_server* s);", "")
        assert any(v.rule == "ffi-missing" and "tb_server_port" in v.message for v in vs), _fmt(vs)

    def test_new_unbound_export_is_flagged(self, tool, tbnet_text):
        vs = self._check(
            tool, tbnet_text,
            "int tb_server_port(const tb_server* s);",
            "int tb_server_port(const tb_server* s);\n"
            "int tb_server_shiny_new_api(tb_server* s);",
        )
        assert any(v.rule == "ffi-unbound" and "tb_server_shiny_new_api" in v.message
                   for v in vs), _fmt(vs)

    def test_unmutated_header_is_clean(self, tool, tbnet_text):
        assert tool.ffi.check(tbnet_text=tbnet_text) == []

    def test_mutated_signatures_flip_the_port_red(self):
        # the other side of the seam: the port's table drifts, the header
        # stays
        import ctypes

        sigs = dict(port_native.SIGNATURES)
        res, args = sigs["tb_server_listen"]
        sigs["tb_server_listen"] = (res, [args[0], args[1], ctypes.c_int64])
        vs = port_ffi.check(signatures=sigs)
        assert any(v.rule == "ffi-type" and "tb_server_listen" in v.message for v in vs), _fmt(vs)


# ---------------------------------------------------------------------------
# 2c. the annotation grammar is enforced
# ---------------------------------------------------------------------------


class TestAnnotations:
    def test_allow_reason_must_be_nonempty(self, tool, tmp_path):
        p = tmp_path / "m.py"
        p.write_text("# fabriclint: allow(hotpath-loop)\nx = 1\n")
        ann = tool.lint.scan_annotations(str(p))
        assert len(ann.bad) == 1 and ann.bad[0].rule == "bad-allow"
        assert "no reason" in ann.bad[0].message

    def test_allow_unknown_rule_is_flagged(self, tool, tmp_path):
        p = tmp_path / "m.py"
        p.write_text("# fabriclint: allow(no-such-rule) because\n")
        ann = tool.lint.scan_annotations(str(p))
        assert len(ann.bad) == 1 and "unknown rule" in ann.bad[0].message

    def test_allow_inside_string_literal_is_ignored(self, tool, tmp_path):
        p = tmp_path / "m.py"
        p.write_text('s = "# fabriclint: allow(hotpath-loop)"\n')
        ann = tool.lint.scan_annotations(str(p))
        assert not ann.bad and not ann.allows

    def test_rules_list_is_closed(self, tool):
        assert "hotpath-lock" in tool.lint.RULES and "ffi-unchecked" in tool.lint.RULES

    def test_the_grammar_is_the_jax_tools(self):
        # one grammar: an allow() either tool accepts, the other accepts
        assert port_lint.RULES == jax_lint.RULES


# ---------------------------------------------------------------------------
# 2d. hot-path purity rules fire (synthetic sources)
# ---------------------------------------------------------------------------

_HOTPATH_BAD = '''
import threading, logging, time
logger = logging.getLogger(__name__)

# fabriclint: hotpath
def drain(self, records):
    with self._lock:
        pass
    self._lock.acquire()
    logger.info("tick")
    print("tick")
    time.sleep(0.1)
    for r in records:
        pass
    squares = [r * r for r in records]
    while records:
        records.pop()
'''

_HOTPATH_OK = '''
import logging
logger = logging.getLogger(__name__)

# fabriclint: hotpath
def drain(self, arr):
    total = arr.sum()
    # fabriclint: allow(hotpath-loop) bounded by distinct methods, not records
    for m in set(arr.tolist()):
        total += m
    try:
        total /= len(arr)
    except ZeroDivisionError:
        logger.exception("error paths may log")
    return total

def unmarked(records):
    for r in records:  # no marker: not on the hot path
        pass
'''


class TestHotpathRules:
    def test_all_rules_fire(self, tool):
        vs = tool.hotpath.check_source("/synthetic/bad.py", _HOTPATH_BAD)
        rules = sorted({v.rule for v in vs})
        assert rules == ["hotpath-io", "hotpath-lock", "hotpath-log", "hotpath-loop"], _fmt(vs)
        loops = [v for v in vs if v.rule == "hotpath-loop"]
        assert len(loops) == 3  # for + comprehension + while

    def test_allows_and_handlers_and_unmarked(self, tool):
        vs = tool.hotpath.check_source("/synthetic/ok.py", _HOTPATH_OK)
        assert not vs, _fmt(vs)

    def test_detached_marker_is_flagged(self, tool):
        src = "# fabriclint: hotpath\n\n\nx = 1\n"
        vs = tool.hotpath.check_source("/synthetic/detached.py", src)
        assert len(vs) == 1 and "not attached" in vs[0].message

    def test_same_violations_on_both_tools(self):
        for src in (_HOTPATH_BAD, _HOTPATH_OK):
            got = {name: [(v.rule, v.line) for v in t.hotpath.check_source("/s.py", src)]
                   for name, t in TOOLS.items()}
            assert got["torch"] == got["jax"]


def _hotpath_markers(pkg_dir):
    out = set()
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build", "fabriclint")]
        for f in filenames:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    src = fh.read()
                if "fabriclint: hotpath" in src:
                    rel = os.path.relpath(path, pkg_dir)
                    out |= {(rel, q) for q in port_hotpath.marked_qualnames(src)}
    return out


def test_the_ports_hotpath_markers_are_the_jax_packages():
    port = _hotpath_markers(PORT_PKG)
    jax = _hotpath_markers(JAX_PKG)
    assert len(jax) == 6
    assert port == jax


def test_marked_qualnames_name_methods_by_class():
    src = ("class A:\n    # fabriclint: hotpath\n    def f(self):\n        pass\n"
           "# fabriclint: hotpath\ndef g():\n    pass\n")
    assert port_hotpath.marked_qualnames(src) == ["A.f", "g"]


# ---------------------------------------------------------------------------
# 2e. keep-alive and error-check rules fire (synthetic sources)
# ---------------------------------------------------------------------------

_KEEPALIVE_BAD = '''
from {pkg}.native import FRAME_FN, LIB

def start(srv, handler):
    LIB.tb_server_set_frame_cb(srv, FRAME_FN(handler), None)
'''

_KEEPALIVE_LOCAL = '''
from {pkg}.native import FRAME_FN, LIB

def start(srv, handler):
    cb = FRAME_FN(handler)  # dies with this frame
    LIB.tb_server_set_frame_cb(srv, cb, None)
'''

_KEEPALIVE_OK = '''
from {pkg}.native import FRAME_FN, LIB

class Plane:
    def __init__(self, srv, handler):
        self._cb = FRAME_FN(handler)
        LIB.tb_server_set_frame_cb(srv, self._cb, None)
'''

_ERRCHECK_SRC = '''
from {pkg}.native import LIB

def f(token, srv):
    LIB.tb_conn_close(token)                      # discarded: violation
    rc = LIB.tb_server_listen(srv, b"0.0.0.0", 0)  # checked: fine
    LIB.tb_server_stop(srv)                        # void restype: fine
    # fabriclint: allow(ffi-unchecked) teardown path, stale token expected
    LIB.tb_conn_close(token)
    return rc
'''


class TestLifetimeAndErrcheck:
    def test_inline_callback_is_flagged(self, tool):
        vs = tool.lifetime.check_source("/synthetic/ka.py", _KEEPALIVE_BAD.format(pkg=tool.package))
        assert len(vs) == 1 and vs[0].rule == "ffi-keepalive", _fmt(vs)

    def test_frame_local_callback_is_flagged(self, tool):
        vs = tool.lifetime.check_source("/synthetic/ka.py",
                                        _KEEPALIVE_LOCAL.format(pkg=tool.package))
        assert len(vs) == 1 and vs[0].rule == "ffi-keepalive", _fmt(vs)

    def test_self_attribute_keepalive_passes(self, tool):
        vs = tool.lifetime.check_source("/synthetic/ka.py", _KEEPALIVE_OK.format(pkg=tool.package))
        assert not vs, _fmt(vs)

    def test_frame_local_holder_attribute_is_flagged(self, tool):
        src = (
            f"from {tool.package}.native import FRAME_FN, LIB\n"
            "def start(srv, make_holder, h):\n"
            "    holder = make_holder(h)\n"
            "    LIB.tb_server_set_frame_cb(srv, holder.cb, None)\n"
        )
        vs = tool.lifetime.check_source("/synthetic/ka.py", src)
        assert len(vs) == 1 and vs[0].rule == "ffi-keepalive", _fmt(vs)

    def test_discarded_return_flagged_checked_and_voided_pass(self, tool):
        vs = tool.errcheck.check_source("/synthetic/ec.py", _ERRCHECK_SRC.format(pkg=tool.package))
        assert len(vs) == 1 and vs[0].rule == "ffi-unchecked", _fmt(vs)
        assert vs[0].line == 5


# ---------------------------------------------------------------------------
# 2f. registry rules fire (synthetic package trees)
# ---------------------------------------------------------------------------


class TestRegistryRules:
    def _pkg_file(self, tool, tmp_path, name, source):
        d = tmp_path / tool.package
        d.mkdir(exist_ok=True)
        p = d / name
        p.write_text(source.format(pkg=tool.package))
        return str(p)

    def test_dead_flag_flagged_read_flag_passes(self, tool, tmp_path):
        p = self._pkg_file(
            tool, tmp_path, "flags_mod.py",
            'from {pkg}.utils.flags import define_flag, get_flag\n'
            'define_flag("zombie_knob", 1, "never read")\n'
            'define_flag("live_knob", 2, "read below")\n'
            'def f():\n    return get_flag("live_knob")\n',
        )
        vs = tool.registry.check_flags([p])
        assert len(vs) == 1 and vs[0].rule == "flag-dead", _fmt(vs)
        assert "zombie_knob" in vs[0].message

    def test_dict_get_does_not_mask_dead_flag(self, tool, tmp_path):
        p = self._pkg_file(
            tool, tmp_path, "flags_mod.py",
            'from {pkg}.utils.flags import define_flag\n'
            'from {pkg}.utils.flags import flag_registry\n'
            'define_flag("shadow_knob", 1, "read only as a dict key")\n'
            'define_flag("registry_knob", 2, "read via the registry")\n'
            'def f(ctx):\n'
            '    _ = ctx.get("shadow_knob")\n'
            '    return flag_registry.get("registry_knob")\n',
        )
        vs = tool.registry.check_flags([p])
        assert len(vs) == 1 and vs[0].rule == "flag-dead", _fmt(vs)
        assert "shadow_knob" in vs[0].message

    def test_flag_without_help_flagged(self, tool, tmp_path):
        p = self._pkg_file(
            tool, tmp_path, "flags_mod.py",
            'from {pkg}.utils.flags import define_flag, get_flag\n'
            'define_flag("mute_knob", 1)\n'
            'def f():\n    return get_flag("mute_knob")\n',
        )
        vs = tool.registry.check_flags([p])
        assert len(vs) == 1 and vs[0].rule == "flag-undocumented", _fmt(vs)

    def test_invalid_bvar_name_flagged(self, tool, tmp_path):
        p = self._pkg_file(
            tool, tmp_path, "bvars_mod.py",
            'from {pkg}.bvar import Adder\n'
            'bad = Adder(name="native plane calls")\n',
        )
        vs = tool.registry.check_bvars([p])
        assert any(v.rule == "bvar-name" for v in vs), _fmt(vs)

    def test_undocumented_native_bvar_flagged(self, tool, tmp_path):
        p = self._pkg_file(
            tool, tmp_path, "bvars_mod.py",
            'from {pkg}.bvar import Adder\n'
            'x = Adder(name="native_totally_new_counter")\n'
            'y = Adder(name="unprefixed_counter_is_fine")\n',
        )
        vs = tool.registry.check_bvars([p])
        assert len(vs) == 1 and vs[0].rule == "bvar-undocumented", _fmt(vs)
        assert "native_totally_new_counter" in vs[0].message

    def test_documented_native_bvar_passes(self, tool, tmp_path):
        p = self._pkg_file(
            tool, tmp_path, "bvars_mod.py",
            'from {pkg}.bvar import Adder\n'
            'x = Adder(name="native_client_calls")\n',
        )
        vs = tool.registry.check_bvars([p])
        assert not vs, _fmt(vs)

    def test_another_packages_file_is_out_of_scope(self, tmp_path):
        # the port's registry pass reads the port's package only
        d = tmp_path / "incubator_brpc_tpu"
        d.mkdir()
        p = d / "flags_mod.py"
        p.write_text('from incubator_brpc_tpu.utils.flags import define_flag\n'
                     'define_flag("zombie_knob", 1)\n')
        assert port_registry.check([str(p)]) == []


# ---------------------------------------------------------------------------
# 3. the sanitizer harness (slow; probe-gated)
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestSanitizers:
    def test_asan_ubsan_native_subset(self):
        from incubator_brpc_tpu_torch.tools.fabriclint import san

        ok, detail = san.probe("asan")
        if not ok:
            pytest.skip(f"asan unsupported here: {detail}")
        assert san.run_asan() == 0

    def test_tsan_ring_stress(self):
        from incubator_brpc_tpu_torch.tools.fabriclint import san

        ok, detail = san.probe("tsan")
        if not ok:
            pytest.skip(f"tsan unsupported here: {detail}")
        assert san.run_tsan() == 0


def test_loader_override_loads_the_named_build(tmp_path):
    """``TBTORCH_HOST_LIB`` makes the port load the library it names and
    build nothing; a missing path leaves the plain Python versions."""
    import subprocess
    import sys

    probe = ("import json; from incubator_brpc_tpu_torch import native; "
             "print(json.dumps([native.NATIVE_AVAILABLE, native.BUILD_INFO.get('path'), "
             "native.BUILD_ERROR is not None]))")
    so = str(port_native.library_path())
    runs = {}
    for name, lib in (("built", so), ("missing", str(tmp_path / "none.so"))):
        env = dict(os.environ, TBTORCH_HOST_LIB=lib)
        proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        runs[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert runs["built"] == [True, so, False]
    assert runs["missing"][0] is False and runs["missing"][2] is True


# ---------------------------------------------------------------------------
# 4. --json reports and the FFI count the README quotes
# ---------------------------------------------------------------------------


class TestJsonReports:
    def test_record_schema(self, tool):
        recs = tool.lint.to_records(
            [tool.lint.Violation("lock-cycle", os.path.join(REPO, "x/y.py"), 7, "boom")]
        )
        assert recs == [{"rule": "lock-cycle", "file": "x/y.py", "line": 7, "reason": "boom"}]

    def test_fabriclint_json_clean(self, capsys):
        from incubator_brpc_tpu_torch.tools.fabriclint.__main__ import main as lint_main

        assert lint_main(["--json"]) == 0
        assert json.loads(capsys.readouterr().out) == []

    def test_verify_rules_registered_in_shared_grammar(self):
        from tools.fabricverify import RULES as VRULES

        assert set(VRULES) <= set(port_lint.RULES)


class TestFfiCountIsGenerated:
    def test_readme_count_matches_signatures(self):
        n = len(port_native.SIGNATURES)
        with open(os.path.join(REPO, "README.md")) as fh:
            text = fh.read()
        quoted = re.findall(r"port's `native\.SIGNATURES` binds (\d+) functions", text)
        assert quoted == [str(n)], (
            f"README.md must quote the port's generated FFI count once ({n} functions "
            f"== len(native.SIGNATURES)); found {quoted}"
        )


def test_chip_smoke_phase_14_on_the_cpu():
    """Phase 14 here: the port's fabriclint clean against the library this
    process loaded, every SIGNATURES name found in it."""
    import chip_smoke

    out = chip_smoke.lint_phase()
    assert out["violations"] == []
    assert out["exported"] == out["declarations"] == out["signatures"] == len(port_native.SIGNATURES)
    assert len(out["hotpath_functions"]) == 6
    assert out["library"] == port_native.BUILD_INFO["path"]
