"""Twins of the dispatcher cases of tests/test_spec.py: the port's
``TpuPushDispatcher`` on the CPU with the speculation plane on
(``test_torch_host_copies.dispatcher_twins``). The file's scheduler cases
are held against JAX in tests/test_torch_spec.py and
tests/test_torch_fused_spec.py."""

import time

from test_torch_host_copies import dispatcher_twins

globals().update(dispatcher_twins("test_spec.py", [
    "test_dispatcher_hedges_straggler_and_replica_wins",
    "test_dispatcher_original_wins_and_replica_is_killed",
    "test_dispatcher_promotes_replica_when_original_worker_dies",
    "test_dispatcher_abandons_hedge_when_its_worker_dies",
    "test_non_speculative_task_never_hedges",
    "test_budget_suppression_is_counted",
    "test_estimator_graded_by_winner_only",
    "test_spec_off_is_inert_everywhere",
    "test_mesh_and_multihost_refuse_speculation",
    "test_e2e_hedge_replica_wins_under_race_monitor",
    "test_e2e_chaos_sigkill_original_mid_hedge_zero_loss",
    "test_resident_ghost_slot_swaps_back_to_reclaimed_original",
    "test_promoted_replica_result_rides_first_wins",
], factory=("_spec_dispatcher", time.monotonic),
   keep=("tpu_faas.spec.straggler",)))
