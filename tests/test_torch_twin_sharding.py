"""Twins of tests/test_sharding.py against
``tpu_faas_torch/store/sharding.py`` (``test_torch_host_copies.load_twins``);
the gateway end-to-end case runs the port's gateway, client SDK and two
local dispatchers over the sharded store."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_sharding.py", {}))
