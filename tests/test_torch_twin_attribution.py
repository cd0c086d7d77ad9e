"""Twins of tests/test_attribution.py against ``tpu_faas_torch/obs``
(``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_attribution.py", {}))
