"""Twins of tests/test_columns.py against ``tpu_faas_torch/core/columns.py``
(``test_torch_host_copies.load_twins``), the dispatcher's intake tests on
the port's dispatcher on the CPU (``dispatcher_on_cpu``)."""

import pytest

from test_torch_host_copies import dispatcher_on_cpu, load_twins

globals().update(load_twins("test_columns.py", {
}))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")
