"""Task graphs: DAG submission, store-side promotion, device-side frontier.

The subsystem spans four layers (ROADMAP item 4):

- **Submission** — the gateway's ``POST /execute_graph`` accepts a node
  list with intra-graph ``depends_on`` refs; :mod:`tpu_faas.graph.validate`
  proves acyclicity + size caps and yields a creation order (children
  before parents, so a parent can never finish against missing child
  records).
- **Promotion plane** — ``TaskStore.complete_dep_many``
  (tpu_faas/store/base.py): every landed terminal write decrements its
  children's pending counts (write-once per-edge claims + atomic hincrby);
  a count hitting zero flips WAITING -> QUEUED and announces on the
  ordinary bus; a FAILED/EXPIRED/CANCELLED parent poisons its transitive
  frontier (WAITING -> FAILED, ``dep_failed:<parent>``) without ever
  dispatching it.
- **Device frontier** — :mod:`tpu_faas.graph.frontier`: the tpu-push
  dispatcher keeps WAITING nodes resident beside the pending batch; the
  tick computes the readiness mask as one segment-reduce over the padded
  edge list INSIDE the jitted device step, plus a data-locality exchange
  that prefers the worker whose payload-plane cache already holds a
  parent's function.
- **Repair** — ``TaskStore.resolve_waiting``: the gateway's result-TTL
  sweeper re-derives an orphaned WAITING node's fate from its parents'
  terminal statuses, so a resolver crash can never strand a node forever.
"""

from tpu_faas_torch.graph.validate import (
    GraphValidationError,
    MAX_GRAPH_NODES,
    validate_graph,
)

__all__ = [
    "GraphValidationError",
    "MAX_GRAPH_NODES",
    "validate_graph",
]
