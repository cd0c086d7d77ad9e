"""Twins of tests/test_obs.py against ``tpu_faas_torch/obs``, the copies it
reads, the port's gateway and the port's dispatcher on the CPU
(``test_torch_host_copies.load_twins``, with ``dispatcher_on_cpu`` on
every case); the cross-process case serves the JAX package's push worker
processes (the JAX file's own launcher). One case is left out, with its
reason (ROADMAP C.8)."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins  # noqa: F401

globals().update(load_twins("test_obs.py", {
    "test_trace_endpoint_full_stack_e2e": "asserts that the dispatcher's "
    "'sent' stamp precedes the worker process's 'exec_start'; against the "
    "port's CPU dispatcher the worker's came first in 5 of 43 runs "
    "(ROADMAP C.8)",
}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
