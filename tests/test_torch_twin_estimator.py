"""Twins of tests/test_estimator.py against
``tpu_faas_torch/sched/estimator.py`` (``test_torch_host_copies.load_twins``);
the cases that drive a dispatcher or workers come with the dispatcher. The
makespan cases feed the copy's estimates to the reference's jitted
``rank_match_placement``, which takes numpy arrays (the port's placement
is held against it in tests/test_torch_greedy.py)."""

from test_torch_host_copies import load_twins

_DISPATCHER = "drives a dispatcher"
globals().update(load_twins("test_estimator.py", {
    "test_dispatcher_learns_sizes_end_to_end": "starts a stack with workers",
    "test_worker_speed_survives_dispatcher_restart_and_purge": _DISPATCHER,
    "test_quantized_speed_row_drifts_back_to_truth": _DISPATCHER,
    "test_dispatcher_learns_param_variants_end_to_end":
        "starts a stack with workers",
    "test_ephemeral_uuid_tokens_never_persist_and_forget_on_purge":
        _DISPATCHER,
    "test_restart_churn_keeps_worker_stats_key_bounded": _DISPATCHER,
    "test_push_worker_flags_minted_token_ephemeral": "drives a worker",
    "test_loser_exec_window_never_grades_workers": _DISPATCHER,
}, keep=("tpu_faas.sched.greedy",)))
