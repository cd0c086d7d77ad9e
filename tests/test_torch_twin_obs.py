"""Twins of tests/test_obs.py against ``tpu_faas_torch/obs``, the copies it
reads, the port's gateway and the port's dispatcher on the CPU
(``test_torch_host_copies.load_twins``, with ``dispatcher_on_cpu`` on
every case); the cross-process cases serve the JAX package's push worker
processes (the JAX file's own launcher)."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins  # noqa: F401

globals().update(load_twins("test_obs.py", {}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
