"""Twins of tests/test_backoff.py and tests/test_config.py against
``tpu_faas_torch/utils`` (``test_torch_host_copies.load_twins``)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_backoff.py", {}))
globals().update(load_twins("test_config.py", {}))
