"""Twins of tests/test_analysis_rules.py against ``tpu_faas_torch/
analysis`` (``test_torch_host_copies.load_twins``): every fixture runs
through the port's ``run_paths`` and CLI, and the real-tree cases scan the
port's package. The cases left out are JAX-only, each with its reason;
``tests/test_torch_analysis.py`` holds the port's own fixtures for the
rewritten checkers (trace, kernelparity, devicesnapshot) and the port's
forms of the store-package exemptions and the real-tree pins."""

from test_torch_host_copies import load_twins

_JIT = ("a fixture under jax.jit / shard_map / pallas_call: the port's trace "
        "checker scopes the card's declared entry points, and has no trace")
_AXIS = ("the unknown-axis-name rule: the port's collectives take the Mesh "
         "object and name no axis, so the rule is dropped "
         "(tpu_faas_torch/analysis/tracesafety.py says why)")
_PALLAS = ("the Pallas in_specs / out_shape / input_output_aliases / "
           "static_argnames tables: the port's kernels are bound through "
           "ctypes, checked by the port's kernelparity fixtures")
_JNP = ("a jnp.asarray / jax.device_put upload: the port's devicesnapshot "
        "checks torch.from_numpy(...).to(non_blocking=True) and its "
        "relatives (tests/test_torch_analysis.py)")

globals().update(load_twins("test_analysis_rules.py", {
    "test_protocol_store_package_is_exempt": "keys on a tpu_faas/store "
    "directory; the port's protocol checker keys on tpu_faas_torch/store "
    "(its form in tests/test_torch_analysis.py)",
    "test_shard_store_package_may_mix_routing": "keys on a tpu_faas/store "
    "directory, as above (its form in tests/test_torch_analysis.py)",
    "test_trace_hazards_fire_with_exact_lines": _JIT,
    "test_trace_reaches_helpers_and_call_site_wraps": _JIT,
    "test_trace_nested_def_hazards_report_once_with_own_scope": _JIT,
    "test_trace_same_named_functions_are_all_analyzed": _JIT,
    "test_trace_static_argnums_indices_are_static": _JIT,
    "test_trace_shard_map_and_pallas_call_are_roots": _JIT,
    "test_trace_fused_kernel_helper_chain_fires": _JIT,
    "test_trace_partial_jit_assignment_wrap_is_a_root": _JIT,
    "test_trace_unknown_axis_fires": _AXIS,
    "test_trace_axis_declared_cross_module": _AXIS,
    "test_trace_unknown_axis_suppressible": _AXIS,
    "test_kernelparity_alias_span_fires": _PALLAS,
    "test_kernelparity_spec_tuple_length_fires": _PALLAS,
    "test_kernelparity_out_shape_dtype_drift_fires": _PALLAS,
    "test_kernelparity_jit_static_argnames_drift_fires": _PALLAS,
    "test_kernelparity_real_tree_registry_pin": "scans JAX's Pallas modules "
    "(sched/pallas_fused.py, pallas_kernels.py); the port's pin scans its "
    "CUDA wrappers (tests/test_torch_analysis.py)",
    "test_devicesnapshot_asarray_then_index_assign_fires": _JNP,
    "test_devicesnapshot_device_put_attr_chain_and_augassign_fires": _JNP,
    "test_devicesnapshot_mutating_method_fires": _JNP,
    "test_devicesnapshot_suppressible": _JNP,
    "test_sarif_carries_new_device_plane_rule_ids": _JNP + "; the port's "
    "SARIF case is in tests/test_torch_analysis.py",
}))


def test_twin_runs_the_ports_analysis():
    assert run_paths.__module__ == "tpu_faas_torch.analysis.core"
    assert analysis_main.__module__ == "tpu_faas_torch.analysis.__main__"
