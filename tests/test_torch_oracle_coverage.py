"""Every oracle of the JAX package's host plane (and of the device-side
files beside it) runs against the port, or says which ROADMAP item will
run it.

For each JAX test file below, each ``def test_`` name must have one of:

- a namesake: a ``def test_`` of the same name in some
  ``tests/test_torch_*.py`` (the port's copies keep the JAX names, and run
  on both packages through the ``pkg`` fixture);
- an entry in ``TWINS``: the port's test that holds the same case under
  another name, as ``file::name``, which must exist;
- an entry in ``DEFERRED``: the ROADMAP item that brings it, which must be
  an open item of ROADMAP.md.

The maps hold exactly the names that need them: an entry whose JAX test is
gone, or that a namesake now covers, fails as stale, so removing any entry
or leaving a dead one fails this file."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"

ORACLES = (
    "test_utils.py", "test_bvar.py", "test_high_concurrency.py", "test_runtime_stress.py",
    "test_robustness.py", "test_rpc.py", "test_runtime.py", "test_http.py",
    "test_parser_robustness.py", "test_iobuf.py", "test_native_containers.py",
    "test_framing.py", "test_fabricnet.py", "test_quantized.py", "test_ring_attention.py",
    "test_mc_dispatch.py", "test_device_link.py", "test_static_analysis.py",
)

# (JAX file, "Class::name" or "name") -> "port file::port test name"
TWINS = {
    ("test_robustness.py", "TestServerAutoLimiter::test_flood_sheds_with_bounded_latency_then_converges"):
        "test_torch_robustness.py::test_flood_sheds_then_converges",
    ("test_robustness.py", "TestLameDuck::test_quitquitquit_page_triggers_drain"):
        "test_torch_http.py::test_quitquitquit_drives_the_lame_duck",
    ("test_robustness.py", "TestLameDuck::test_quitquitquit_gated_off_by_default"):
        "test_torch_http.py::test_quitquitquit_drives_the_lame_duck",
    ("test_rpc.py", "TestAdmission::test_method_elimit"):
        "test_torch_robustness.py::test_limit_one",
    ("test_rpc.py", "TestAdmission::test_server_level_limit"):
        "test_torch_robustness.py::test_limit_one",
    ("test_native_containers.py", "TestFiberCond::test_wait_timeout"):
        "test_torch_hotspots_logging.py::test_cond_wait_timeout",
    ("test_native_containers.py", "TestCountdownEvent::test_wait_timeout"):
        "test_torch_hotspots_logging.py::test_countdown_wait_timeout",
    ("test_framing.py", "test_frame_parse_roundtrip"):
        "test_torch_framing.py::test_roundtrip_flags_and_cid",
    ("test_framing.py", "test_parse_rejects_corruption"):
        "test_torch_framing.py::test_parse_matches_reference",
    ("test_framing.py", "test_echo_step_roundtrip"):
        "test_torch_tensor_echo.py::test_make_echo_step_matches_reference",
    ("test_framing.py", "test_echo_step_bad_frame_gets_error_response"):
        "test_torch_tensor_echo.py::test_error_codes_and_zeroed_payloads",
    ("test_framing.py", "test_multi_method_dispatch"):
        "test_torch_tensor_echo.py::test_duplicate_method_and_bad_handler_rejected",
    ("test_framing.py", "test_sparse_method_ids_and_enomethod"):
        "test_torch_tensor_echo.py::test_single_step_matches_reference",
    ("test_fabricnet.py", "test_forward_shapes_single_device"):
        "test_torch_fabricnet.py::test_init_params_and_batch_shapes",
    ("test_fabricnet.py", "test_train_step_decreases_loss_8dev"):
        "test_torch_fabricnet.py::test_mesh_fused_steps_match_jax",
    ("test_fabricnet.py", "test_sharded_forward_matches_single_device"):
        "test_torch_fabricnet.py::test_mesh_forward_matches_jax",
    ("test_fabricnet.py", "test_heads_zero_ring_mean_path"):
        "test_torch_fabricnet.py::test_forward_matches_jax",
    ("test_fabricnet.py", "TestOverlapSchedule::test_overlapped_bit_identical_to_serialized"):
        "test_torch_fabricnet.py::test_mesh_serialized_equals_overlapped_byte_for_byte",
    ("test_fabricnet.py", "TestOverlapSchedule::test_sliced_schedule_matches_fused_grads"):
        "test_torch_fabricnet.py::test_train_step_on_slices_equals_the_whole_parameter_step",
    ("test_fabricnet.py", "TestOverlapSchedule::test_overlapped_schedule_trains"):
        "test_torch_fabricnet.py::test_mesh_overlapped_step_matches_jax",
    ("test_fabricnet.py", "TestOverlapSchedule::test_unknown_schedule_rejected"):
        "test_torch_fabricnet.py::test_schedules",
    ("test_fabricnet.py", "test_graft_entry_dryrun"):
        "test_torch_entry.py::test_dryrun_multichip_prints_every_key_of_the_jax_line",
    ("test_fabricnet.py", "test_graft_entry_single"):
        "test_torch_entry.py::test_entry_matches_the_jax_entry_on_the_same_parameters",
    ("test_quantized.py", "TestQuantizedSessions::test_session_matches_model_and_bound"):
        "test_torch_session_rpc.py::test_quantized_session_matches_model_and_bound",
    ("test_quantized.py", "TestTopologySchedule::test_slowest_measured_link_first"):
        "test_torch_device_link.py::test_schedule_session_order_equals_the_jax_package",
    ("test_quantized.py", "TestTopologySchedule::test_rtt_breaks_bandwidth_ties"):
        "test_torch_device_link.py::test_schedule_session_order_equals_the_jax_package",
    ("test_quantized.py", "TestTopologySchedule::test_unmeasured_parties_keep_mesh_order_at_tail"):
        "test_torch_device_link.py::test_schedule_session_order_equals_the_jax_package",
    ("test_quantized.py", "TestTopologySchedule::test_no_telemetry_is_mesh_order"):
        "test_torch_device_link.py::test_schedule_session_order_equals_the_jax_package",
    ("test_quantized.py", "TestLinkProfileAccessor::test_live_link_profile"):
        "test_torch_device_link.py::test_link_profile_of_a_live_link",
    ("test_ring_attention.py", "TestRingAttention::test_matches_full_attention"):
        "test_torch_ring_attention.py::test_matches_jax_ring_attention",
    ("test_ring_attention.py", "TestRingAttention::test_single_rank_degenerates_to_full"):
        "test_torch_ring_attention.py::test_matches_jax_ring_attention",
    ("test_ring_attention.py", "TestRingAttention::test_grads_flow"):
        "test_torch_ring_attention.py::test_grads_match_jax",
    ("test_mc_dispatch.py",
     "TestInProcessSessions::test_byte_identical_with_single_controller_fused_dispatch"):
        "test_torch_session_rpc.py::test_byte_identical_with_the_fused_dispatch_model",
    ("test_mc_dispatch.py", "test_fingerprint_mismatch_rejects_cleanly"):
        "test_torch_mc_session.py::test_fingerprint_mismatch_rejects_before_any_step",
    ("test_mc_dispatch.py", "test_parallel_channel_lowers_through_mc_plane"):
        "test_torch_mc_session.py::test_parallel_channel_lowers_through_the_plane_and_a_fabric_collective",
    ("test_mc_dispatch.py", "test_chaos_kill_at_step_resumes"):
        "test_torch_mc_session.py::test_chaos_party_dies_at_step_k_and_the_session_heals",
    ("test_static_analysis.py", "TestFfiCountIsGenerated::test_parity_row_53_count_matches_signatures"):
        "test_torch_static_analysis.py::test_readme_count_matches_signatures",
    ("test_static_analysis.py", "TestFfiCountIsGenerated::test_analysis_md_count_matches_signatures"):
        "test_torch_static_analysis.py::test_readme_count_matches_signatures",
}

# (JAX file, "Class" or "Class::name" or "name") -> the ROADMAP item that brings it
_A13B_VERIFY = "A13b: fabricverify"
_A13B_SCAN = "A13b: fabricscan"
DEFERRED = {
    ("test_device_link.py", "TestCollectiveLowering"): "A3c",
    ("test_device_link.py", "TestFabricFailurePaths::test_fused_falls_back_when_one_link_is_dead"):
        "A3c",
    ("test_device_link.py", "TestDynamicPartitionFused"): "A3c",
    ("test_static_analysis.py", "TestFabricverifyClean"): _A13B_VERIFY,
    ("test_static_analysis.py", "TestLockCoverage"): _A13B_VERIFY,
    ("test_static_analysis.py", "TestLockOrderMeta"): _A13B_VERIFY,
    ("test_static_analysis.py", "TestLifecycleMeta"): _A13B_VERIFY,
    ("test_static_analysis.py", "TestModelChecker"): _A13B_VERIFY,
    ("test_static_analysis.py", "TestJsonReports::test_fabricverify_json_clean"): _A13B_VERIFY,
    ("test_static_analysis.py", "TestScanRepoIsClean"): _A13B_SCAN,
    ("test_static_analysis.py", "TestScanCoverageIsAllowlistFree"): _A13B_SCAN,
    ("test_static_analysis.py", "TestWireBoundsCatchesMutations"): _A13B_SCAN,
    ("test_static_analysis.py", "TestOwnershipCatchesMutations"): _A13B_SCAN,
    ("test_static_analysis.py", "TestPlaneParityCatchesMutations"): _A13B_SCAN,
}


def _test_names(path):
    """``Class::name`` (or ``name`` at module level) of each test function."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out += [f"{node.name}::{f.name}" for f in node.body
                    if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")]
    return out


def _port_names():
    names = {}
    for path in sorted(TESTS.glob("test_torch_*.py")):
        for qual in _test_names(path):
            names.setdefault(qual.rpartition("::")[2], set()).add(path.name)
    return names


def _uncovered(twins, deferred):
    """The (file, name) pairs with no namesake, twin or deferral, and the
    map entries that no uncovered name needs."""
    port = _port_names()
    missing, used = [], set()
    for file in ORACLES:
        for qual in _test_names(TESTS / file):
            if qual.rpartition("::")[2] in port:
                continue
            if (file, qual) in twins:
                used.add(("twin", file, qual))
                continue
            key = next((k for k in ((file, qual), (file, qual.partition("::")[0]))
                        if k in deferred), None)
            if key is not None:
                used.add(("deferred",) + key)
                continue
            missing.append(f"{file}::{qual}")
    entries = {("twin",) + k for k in twins} | {("deferred",) + k for k in deferred}
    stale = sorted(entries - used)
    return missing, stale


def test_every_jax_oracle_has_a_port_namesake_twin_or_roadmap_item():
    missing, stale = _uncovered(TWINS, DEFERRED)
    assert missing == [], "JAX oracles the port runs nowhere:\n" + "\n".join(missing)
    assert stale == [], f"map entries no uncovered name needs: {stale}"


def test_every_twin_names_a_port_test_that_exists():
    port = _port_names()
    for (file, qual), twin in TWINS.items():
        twin_file, _, twin_name = twin.partition("::")
        assert twin_file in port.get(twin_name, set()), f"{file}::{qual} -> {twin}: no such test"


def test_every_deferral_names_an_open_roadmap_item():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    open_items = roadmap.split("## Open items", 1)[1].split("### C.", 1)[0]
    for (file, qual), item in DEFERRED.items():
        label = item.split(":")[0]
        assert re.search(rf"^{re.escape(label)}\. ", open_items, re.M), (
            f"{file}::{qual} defers to {label!r}, which is no open item of ROADMAP.md")


@pytest.mark.parametrize("which", ["twin", "deferred"])
def test_removing_any_entry_fails(which):
    entries = TWINS if which == "twin" else DEFERRED
    for key in entries:
        if which == "twin":
            missing, _ = _uncovered({k: v for k, v in TWINS.items() if k != key}, DEFERRED)
        else:
            missing, _ = _uncovered(TWINS, {k: v for k, v in DEFERRED.items() if k != key})
        assert missing, f"removing {key} went unnoticed"


def test_a_stale_entry_fails():
    twins = dict(TWINS)
    twins[("test_utils.py", "test_endpoint_parse_v4")] = "test_torch_utils.py::test_endpoint_parse_v4"
    _, stale = _uncovered(twins, DEFERRED)
    assert stale == [("twin", "test_utils.py", "test_endpoint_parse_v4")]
