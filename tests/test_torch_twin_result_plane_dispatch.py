"""Twins of the dispatcher cases of tests/test_result_plane.py: the port's
``TpuPushDispatcher`` on the CPU with the result data plane on
(``test_torch_host_copies.dispatcher_twins``), behind the port's gateway,
against the port's push worker: the file's task functions come from the
port's ``workloads``, and ``merge_deps`` reads its parents' bodies through
the port executor's ``dep_values``, which the port's worker fills."""

from test_torch_host_copies import dispatcher_twins

globals().update(dispatcher_twins("test_result_plane.py", [
    "test_result_blobs_requires_graph_frontier",
    "test_digest_result_intake_and_dep_digest_dispatch",
    "test_reverse_pull_fans_out_to_worker_and_store",
    "test_reverse_pull_missing_body_fails_consumers",
    "test_reverse_pull_resend_sweep_and_reconnect_clears_mirror",
    "test_plane_off_frames_and_records_are_legacy_shaped",
    "test_result_plane_e2e_chain_never_round_trips_store",
    "test_dep_results_control_lane_reads_bodies_from_store",
], factory=("_mk_disp",)))


def test_twin_runs_the_ports_worker_and_workloads():
    assert merge_deps.__module__ == "tpu_faas_torch.workloads"
    assert PushWorker.__module__ == "tpu_faas_torch.worker.push_worker"
