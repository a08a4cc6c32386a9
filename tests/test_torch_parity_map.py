"""Every test function of the JAX package's own suites has a counterpart
in the port's, or a stated reason why none can exist.

The JAX suites are the ``tests/test_*.py`` files that are not
``tests/test_torch_*.py``.  With ``ast`` this file lists each one's test
functions, and maps each function:

1. to ``NOT_PORTED``, with its reason: a TPU layout, an XLA compile or
   recompile bucket, or an XLA/TPU precision knob, none of which the
   CUDA port has;
2. else to ``MAP``'s port test node ids, where the counterpart has
   another name;
3. else to the test of the same name in one of ``FILES``' port files for
   its JAX file.

A function that maps nowhere fails, and so do stale entries: a
``NOT_PORTED`` or ``MAP`` key that names no JAX test function, a node id
that names no port test, a file in ``FILES`` that does not exist, and a
JAX file that ``FILES`` does not list.  Deleting any entry therefore
fails the map (each one is a function's only route)."""

import ast
import functools
import pathlib

import pytest

TESTS = pathlib.Path(__file__).resolve().parent

# JAX file -> the port files holding its counterparts by name
FILES = {
    "test_api_surface.py": (),
    "test_arrow.py": ("test_torch_arrow_suite.py",),
    "test_bin_repair.py": ("test_torch_bin_repair_suite.py",),
    "test_builder.py": ("test_torch_builder_suite.py",),
    "test_clustering.py": ("test_torch_clustering_suite.py",
                           "test_torch_native_clustering.py"),
    "test_csr_oracle.py": ("test_torch_csr_oracle.py",),
    "test_distributed.py": ("test_torch_distributed.py",
                            "test_torch_distributed_energy.py"),
    "test_eigenmaps.py": ("test_torch_eigenmaps_suite.py",
                          "test_torch_builder.py"),
    "test_energy.py": ("test_torch_energy_suite.py",),
    "test_energy_approx.py": ("test_torch_energy_approx_suite.py",),
    "test_energy_comparisons.py": ("test_torch_energy_comparisons.py",),
    "test_energy_session.py": (),
    "test_fuzz_shapes.py": ("test_torch_fuzz_shapes.py",),
    "test_graph_factory_scenarios.py":
        ("test_torch_graph_factory_scenarios.py",),
    "test_hypergraph.py": ("test_torch_hypergraph.py",),
    "test_index.py": ("test_torch_index_suite.py",),
    "test_laplacian.py": ("test_torch_laplacian_suite.py",),
    "test_live.py": ("test_torch_live.py",),
    "test_magnitude_sensitivity.py": ("test_torch_magnitude_sensitivity.py",),
    "test_migration_surface.py": ("test_torch_migration_surface.py",),
    "test_multiprocess.py": ("test_torch_multiprocess.py",),
    "test_pallas_kernels.py": ("test_torch_kernel_suite.py",),
    "test_precision.py": ("test_torch_precision.py",),
    "test_precompile.py": (),
    "test_pruned.py": ("test_torch_pruned.py",),
    "test_querying.py": ("test_torch_querying.py",),
    "test_querying_proj.py": ("test_torch_querying_proj.py",),
    "test_reduction.py": ("test_torch_reduction_suite.py",),
    "test_reference_asserts.py": ("test_torch_reference_asserts.py",),
    "test_reference_parity.py": ("test_torch_csr_oracle.py",),
    "test_sampling_scenarios.py": ("test_torch_sampling_scenarios.py",),
    "test_spectral_invariants.py": ("test_torch_spectral_invariants.py",),
    "test_storage.py": ("test_torch_storage.py",),
    "test_taumode.py": ("test_torch_taumode_suite.py",),
}

_GOLDEN = ("test_torch_index.py::test_reference_parity_golden",)
_ENERGY = "test_torch_energy.py::"
_SESSION = "test_torch_energy_session.py::"
_DIST = "test_torch_distributed.py::"

# "JAX file::function" -> port node ids of another name
MAP = {
    "test_api_surface.py::test_all_exports_resolve": (
        "test_torch_surface.py::"
        "test_every_jax_name_and_parameter_has_a_counterpart",
        "test_torch_surface.py::test_the_kernel_module_map_resolves"),
    "test_api_surface.py::test_api_doc_covers_every_export": (
        "test_torch_surface.py::"
        "test_shared_names_are_documented_in_the_api_reference",),
    "test_clustering.py::test_native_matches_numpy": (
        "test_torch_native_clustering.py::"
        "test_native_scan_matches_jax_numpy_scan",
        "test_torch_native_clustering.py::"
        "test_native_scan_matches_its_plain_version"),
    "test_clustering.py::test_chunked_device_engine_matches_host": (
        "test_torch_chunked_clustering.py::test_engine_equals_host_path",),
    "test_clustering.py::test_chunked_device_engine_partial_tail": (
        "test_torch_chunked_clustering.py::test_chunked_scan_misaligned_tail",),
    "test_clustering.py::test_twonn_device_matches_host": (
        "test_torch_chunked_clustering.py::"
        "test_twonn_device_tile_matches_jax",),
    "test_clustering.py::test_chunked_atcap_device_decisions_match_host": (
        "test_torch_chunked_clustering.py::test_chunked_scan_matches_jax",),
    "test_distributed.py::test_sharded_lambdas_match_single_device": (
        _DIST + "test_sharded_lambdas_match",),
    "test_distributed.py::test_distributed_topk_matches_single_device": (
        _DIST + "test_distributed_topk_matches_jax",),
    "test_distributed.py::test_distributed_search_session_matches_single": (
        _DIST + "test_distributed_search_session_matches",),
    "test_distributed.py::test_distributed_index_step_runs": (
        _DIST + "test_distributed_index_step_matches_jax",),
    "test_distributed.py::test_distributed_pruned_matches_oracle": (
        _DIST + "test_distributed_pruned_matches_jax",),
    "test_distributed.py::test_hierarchical_2d_topk_matches_single_device": (
        _DIST + "test_hierarchical_2d_topk_matches",),
    "test_distributed.py::test_distributed_topk_pallas_per_shard": (
        _DIST + "test_distributed_merge_float32_matches_jax_pallas",),
    "test_distributed.py::test_sharded_fused_taulambda_matches_single_device":
        (_DIST + "test_sharded_lambdas_match",),
    "test_distributed.py::test_streamed_matches_in_memory": (
        "test_torch_streaming.py::test_streamed_matches_jax_and_in_memory",),
    "test_distributed.py::test_distributed_binned_matches_xla": (
        _DIST + "test_distributed_binned_flags_shard_collision",
        _DIST + "test_distributed_session_binned_parity_and_repair_wiring"),
    "test_energy.py::test_energy_params_defaults": (
        _ENERGY + "test_energy_params_defaults_match_jax",),
    "test_energy.py::test_robust_scale_and_bounded_l2": (
        _ENERGY + "test_robust_scale_and_bounded_l2_match_jax",),
    "test_energy.py::test_optical_compression": (
        _ENERGY + "test_optical_compression_matches_jax",),
    "test_energy.py::test_bootstrap_laplacian_centroid_space": (
        _ENERGY + "test_bootstrap_laplacian_matches_jax",),
    "test_energy.py::test_diffusion_smooths": (
        _ENERGY + "test_diffusion_matches_jax",
        _ENERGY + "test_diffuse_and_split_matches_jax"),
    "test_energy.py::test_node_energy_and_dispersion": (
        _ENERGY + "test_node_energy_and_dispersion_matches_jax",),
    "test_energy.py::test_build_energy_requires_dims_reduction": (
        _ENERGY + "test_build_energy_needs_dims_reduction",),
    "test_energy.py::test_build_energy_end_to_end": (
        _ENERGY + "test_build_energy_matches_jax",),
    "test_energy.py::test_search_energy_ranking": (
        _ENERGY + "test_search_energy_single_matches_jax",),
    "test_energy.py::test_sparsifier": (
        "test_torch_leftovers.py::test_sparsifier_matches_jax",
        "test_torch_leftovers.py::test_sparsifier_dense_graph_matches_jax"),
    "test_energy.py::test_tall_graph_ceiling_reference_parity": (
        _ENERGY + "test_tall_graph_raises_without_allow_tall_graphs",),
    "test_energy_session.py::test_energy_session_matches_batch_api": (
        _SESSION + "test_search_energy_batch_matches_jax",
        _SESSION + "test_session_matches_jax_session_with_a_partial_tail"),
    "test_energy_session.py::test_energy_session_partial_tail": (
        _SESSION + "test_session_matches_jax_session_with_a_partial_tail",),
    "test_energy_session.py::test_energy_session_dim_mismatch_raises": (
        _SESSION + "test_session_dim_mismatch_raises",),
    "test_energy_session.py::test_energy_session_weight_sweep": (
        _SESSION + "test_session_weight_sweep_matches_jax",),
    "test_index.py::test_stream_driver_repairs_flagged_rows": (
        "test_torch_index_suite.py::test_stream_loop_repairs_flagged_rows_jax",
        "test_torch_index_suite.py::"
        "test_stream_loop_repairs_flagged_rows_torch"),
    "test_index.py::test_stream_driver_host_casts_batches": (
        "test_torch_index_suite.py::test_stream_loop_host_casts_batches_jax",
        "test_torch_index_suite.py::test_stream_loop_host_casts_batches_torch"),
    "test_index.py::test_warm_step_compiles_production_driver_path": (
        "test_torch_index_suite.py::test_warmup_drives_the_production_path",),
    "test_multiprocess.py::test_put_global_single_process_is_device_put": (
        "test_torch_multiprocess.py::test_put_global_single_process",),
    "test_multiprocess.py::test_two_process_build_query_serve": (
        "test_torch_multiprocess.py::"
        "test_multiprocess_dryrun_matches_one_process",),
    "test_multiprocess.py::test_four_process_build_query_serve": (
        "test_torch_multiprocess.py::"
        "test_multiprocess_dryrun_matches_one_process",),
    "test_precision.py::test_single_query_duplicate_tie_order_cpu": (
        "test_torch_precision.py::test_single_query_duplicate_tie_order_cpu_jax",
        "test_torch_precision.py::"
        "test_single_query_duplicate_tie_order_cpu_torch"),
    "test_precision.py::test_pad_skipped_under_default_device_cpu": (
        "test_torch_precision.py::test_pad_skipped_under_default_device_cpu_jax",
        "test_torch_precision.py::test_single_query_plane_is_its_batch_row_torch"),
    "test_precision.py::test_forced_query_pad_slices_back": (
        "test_torch_precision.py::test_forced_query_pad_slices_back_jax",
        "test_torch_precision.py::test_single_query_plane_is_its_batch_row_torch"),
    "test_precompile.py::test_warm_returns_no_failures": (
        "test_torch_leftovers.py::test_precompile_warms_the_engines_the_gate_picks",
        "test_torch_leftovers.py::test_precompile_names_failures"),
    "test_pruned.py::test_extract_topk_lowest_id_matches_two_key_sort": (
        "test_torch_pruned.py::test_extract_topk_lowest_id_matches_jax",),
    "test_reference_parity.py::test_lambda_parity": _GOLDEN,
    "test_reference_parity.py::test_lambda_parity_other_tau_policies": _GOLDEN,
    "test_reference_parity.py::test_graph_parity": _GOLDEN,
    "test_reference_parity.py::test_query_lambda_parity": _GOLDEN,
    "test_reference_parity.py::test_topk_parity": _GOLDEN,
    "test_reference_parity.py::test_graph_invariants_on_real_data": _GOLDEN,
    "test_reference_parity.py::test_matmul_vs_direct_on_real_data": (
        "test_torch_csr_oracle.py::test_three_way_on_reference_fixtures",),
}

_LAYOUT = ("a Pallas layout of the TPU kernel (VMEM tile, query block, lane "
           "split, pre-reduce); the CUDA kernel picks its CTA shape from F "
           "and B (tests/test_torch_surface.py _PALLAS)")
_XLA_COMPILE = ("an XLA compile or its persistent cache; the port's kernels "
                "are one nvcc library built once and compile nothing per "
                "shape")

# "JAX file::function" -> why the port has no counterpart
NOT_PORTED = {
    "test_pallas_kernels.py::test_fused_taulambda_fits_budget":
        "the Pallas kernel's VMEM budget; K2's gate is its shared memory, "
        "held to the kernel in tests/test_torch_lambda_tc.py",
    "test_pallas_kernels.py::test_resolve_layout_fits_padded_block": _LAYOUT,
    "test_pallas_kernels.py::"
    "test_resolve_layout_partial_pin_keeps_auto_pre_reduce": _LAYOUT,
    "test_pallas_kernels.py::test_binned_topk_auto_layout_decision": _LAYOUT,
    "test_pallas_kernels.py::test_fused_select_tau_sublane_layouts_match_lane":
        _LAYOUT + "; the cases' exactness runs at the port's defaults in "
        "test_torch_kernel_suite.py::"
        "test_fused_select_tau_matches_lane_layout",
    "test_bin_repair.py::test_warm_step_compiles_repair_program":
        _XLA_COMPILE + " (the repair's padded_take buckets)",
    "test_taumode.py::test_query_prep_precision_plumbing":
        "QUERY_PREP_PRECISION, a jax.lax.Precision for the TPU MXU's "
        "passes; TF32 is off for every product of the port",
    "test_clustering.py::test_bucket_rows_schedule":
        "config.bucket_rows, row buckets that bound Mosaic recompiles",
    "test_precompile.py::test_centroid_cap_buckets_cover_sweep_outcomes":
        _XLA_COMPILE + " (one clustering program per centroid-cap bucket)",
    "test_precompile.py::test_aot_matches_runtime_build_programs":
        _XLA_COMPILE + " (AOT keys equal to the runtime's)",
    "test_precompile.py::test_warm_energy_matches_runtime_chunked":
        _XLA_COMPILE + " (AOT keys equal to the runtime's)",
    "test_precompile.py::test_aot_matches_runtime_session_step":
        _XLA_COMPILE + " (AOT keys equal to the runtime's)",
    "test_precompile.py::test_warm_bf16_skipped_off_tpu":
        "the JAX package's bf16 sessions need a TPU, so its warm skips "
        "them elsewhere; the port's bf16 modes run on any CUDA card and "
        "warm where asked (test_torch_leftovers.py::"
        "test_precompile_warms_the_engines_the_gate_picks)",
}


def _tests(path: pathlib.Path) -> list:
    """The test function names of a file (``Class.method`` for methods)."""
    tree = ast.parse(path.read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("test_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out += [f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and m.name.startswith("test_")]
    return out


def _jax_files() -> list:
    return sorted(p.name for p in TESTS.glob("test_*.py")
                  if not p.name.startswith("test_torch_"))


_PORT_CACHE: dict = {}


def _port_tests(name: str) -> set:
    if name not in _PORT_CACHE:
        path = TESTS / name
        _PORT_CACHE[name] = set(_tests(path)) if path.is_file() else None
    return _PORT_CACHE[name]


def _node_exists(node: str) -> bool:
    name, _, fn = node.partition("::")
    tests = _port_tests(name)
    return tests is not None and fn in tests


@functools.lru_cache(maxsize=None)
def routes():
    """Every JAX test function with its route: (key, ("not_ported",
    reason) | ("map", node ids) | ("name", node ids) | ("none", ()))."""
    out = []
    for jf in _jax_files():
        for fn in _tests(TESTS / jf):
            key = f"{jf}::{fn}"
            if key in NOT_PORTED:
                out.append((key, ("not_ported", NOT_PORTED[key])))
            elif key in MAP:
                out.append((key, ("map", MAP[key])))
            else:
                nodes = tuple(f"{pf}::{fn}" for pf in FILES.get(jf, ())
                              if _node_exists(f"{pf}::{fn}"))
                out.append((key, ("name", nodes) if nodes else ("none", ())))
    return tuple(out)


def test_every_jax_test_function_is_mapped():
    unmapped = [key for key, (kind, _) in routes() if kind == "none"]
    assert not unmapped, (
        f"JAX test functions without a port counterpart: {unmapped}; port "
        "them as tests/test_torch_*.py cases (same name, or MAP), or list "
        "them in NOT_PORTED with the XLA/TPU reason")


def test_every_mapped_node_exists():
    missing = [(key, n) for key, (kind, nodes) in routes()
               if kind == "map" for n in nodes if not _node_exists(n)]
    assert not missing, f"MAP names port tests that do not exist: {missing}"


def test_no_stale_entries():
    live = {key for key, _ in routes()}
    stale = [k for k in list(MAP) + list(NOT_PORTED) if k not in live]
    assert not stale, f"entries naming no JAX test function: {stale}"
    both = set(MAP) & set(NOT_PORTED)
    assert not both, f"both mapped and NOT_PORTED: {both}"


def test_every_jax_file_is_listed_and_every_port_file_exists():
    files = _jax_files()
    assert sorted(FILES) == files, (
        f"unlisted: {sorted(set(files) - set(FILES))}; "
        f"gone: {sorted(set(FILES) - set(files))}")
    gone = [pf for pfs in FILES.values() for pf in pfs
            if not (TESTS / pf).is_file()]
    assert not gone, f"FILES names port files that do not exist: {gone}"


@pytest.mark.parametrize("key", sorted(NOT_PORTED))
def test_every_exception_has_a_reason(key):
    assert len(NOT_PORTED[key]) > 40, key
