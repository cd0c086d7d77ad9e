"""Twins of the dispatcher cases of tests/test_graph.py: the port's
``TpuPushDispatcher`` on the CPU with the graph frontier on the batch tick
(``test_torch_host_copies.dispatcher_twins``), behind the JAX package's
gateway, client SDK and workers. The frontier's device ops are held
against JAX in tests/test_torch_graph.py."""

from test_torch_host_copies import dispatcher_twins

globals().update(dispatcher_twins("test_graph.py", [
    "test_frontier_dispatches_in_tick_when_promotion_announce_is_lost",
    "test_frontier_dispatched_mid_node_still_promotes_its_children",
    "test_frontier_blocks_unready_children",
    "test_tpu_push_graph_diamond_e2e",
    "test_graph_chaos_worker_kill_mid_diamond",
    "test_graph_poison_chaos_failed_parent_never_dispatches_frontier",
], factory=("_make_tpu_dispatcher", "memory://")))
