"""Twins of the in-process part of tests/test_sharding.py against
``tpu_faas_torch/store/sharding.py`` (``test_torch_host_copies.load_twins``);
the gateway end-to-end case drives the local dispatcher, not ported yet
(ROADMAP A.12)."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_sharding.py", {
    "test_gateway_over_sharded_store_end_to_end":
        "starts a gateway and the local dispatcher (ROADMAP A.12)",
}))
