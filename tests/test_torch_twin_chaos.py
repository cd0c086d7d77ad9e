"""Twins of tests/test_chaos_plane.py against ``tpu_faas_torch/chaos``
(``test_torch_host_copies.load_twins``); the case that starts a process
is left out."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_chaos_plane.py", {
    "test_chaos_off_exposition_byte_identical": "starts a process",
}))
