"""Twins of tests/test_core.py against the port's copies in
``tpu_faas_torch/core``: the same tests, with their imports of modules the
port has renamed (``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_core.py", {}))
