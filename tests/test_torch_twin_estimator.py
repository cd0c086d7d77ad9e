"""Twins of tests/test_estimator.py against
``tpu_faas_torch/sched/estimator.py`` (``test_torch_host_copies.load_twins``);
the dispatcher cases run the port's dispatcher on the CPU
(``dispatcher_on_cpu``); the cases that start worker processes are left
out. The
makespan cases feed the copy's estimates to the reference's jitted
``rank_match_placement``, which takes numpy arrays (the port's placement
is held against it in tests/test_torch_greedy.py)."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins

globals().update(load_twins("test_estimator.py", {
    "test_dispatcher_learns_sizes_end_to_end": "starts a stack with workers",
    "test_dispatcher_learns_param_variants_end_to_end":
        "starts a stack with workers",
    "test_push_worker_flags_minted_token_ephemeral": "drives a worker",
}, keep=("tpu_faas.sched.greedy",)))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
