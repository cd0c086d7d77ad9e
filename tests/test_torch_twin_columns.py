"""Twins of tests/test_columns.py against ``tpu_faas_torch/core/columns.py``
(``test_torch_host_copies.load_twins``); the dispatcher's intake tests
come with the dispatcher."""

from test_torch_host_copies import load_twins

_DISPATCHER = "drives a dispatcher"
globals().update(load_twins("test_columns.py", {
    "test_columnar_intake_equivalent_to_dict_plane": _DISPATCHER,
    "test_columnar_overflow_falls_back_per_task_not_per_poll": _DISPATCHER,
    "test_claim_loser_releases_its_row": _DISPATCHER,
}))
