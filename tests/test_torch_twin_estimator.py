"""Twins of tests/test_estimator.py against
``tpu_faas_torch/sched/estimator.py`` (``test_torch_host_copies.load_twins``);
the dispatcher cases run the port's dispatcher on the CPU
(``dispatcher_on_cpu``), and the worker case the port's ``PushWorker``;
the two end-to-end cases are left out, since they build their dispatcher
in their bodies with ``tests.test_tpu_push_e2e._make_dispatcher``, JAX's,
which no override reaches. The
makespan cases feed the copy's estimates to the reference's jitted
``rank_match_placement``, which takes numpy arrays (the port's placement
is held against it in tests/test_torch_greedy.py)."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins

_JAX_FACTORY = ("builds JAX's dispatcher in its body "
                "(tests.test_tpu_push_e2e._make_dispatcher)")
globals().update(load_twins("test_estimator.py", {
    "test_dispatcher_learns_sizes_end_to_end": _JAX_FACTORY,
    "test_dispatcher_learns_param_variants_end_to_end": _JAX_FACTORY,
}, keep=("tpu_faas.sched.greedy",)))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
