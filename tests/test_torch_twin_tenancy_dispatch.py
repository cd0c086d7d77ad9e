"""Twins of the dispatcher cases of tests/test_tenancy.py: the port's
``TpuPushDispatcher`` on the CPU with the tenancy plane on
(``test_torch_host_copies.dispatcher_twins``). The file's scheduler cases
are held against JAX in tests/test_torch_tenancy.py and
tests/test_torch_fused_tenancy.py."""

from test_torch_host_copies import dispatcher_twins

globals().update(dispatcher_twins("test_tenancy.py", [
    "test_dispatcher_tenancy_requires_single_device",
    "test_dispatcher_fair_dispatch_and_observability",
    "test_dispatcher_unregistered_tenant_buckets_to_other",
    "test_dispatcher_hot_reload_from_store",
    "test_dispatcher_resident_tenancy_e2e",
    "test_inflight_gauge_sums_rows_sharing_other_label",
    "test_churn_soak_bookkeeping_stays_bounded",
], factory=("_mk_disp",), keep=("tpu_faas.tenancy.fairshare",)))
