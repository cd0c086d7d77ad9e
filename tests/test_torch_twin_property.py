"""Twins of tests/test_property.py (hypothesis): serialization, the
executor's wire format, RESP framing and ``MemoryStore`` of the port; the
port's rank placement (``sched/greedy.py``) feasible on arbitrary fleets at
the file's one fixed padded shape; the port's race monitor on legal
histories; the resident tick's ``_first_k_indices`` of the port on torch
tensors; and the port's hash ring (``test_torch_host_copies.load_twins``;
the one ``import jax.numpy as jnp`` in a test's body becomes torch, whose
``asarray`` takes the mask alike; the placement runs with ``device="cpu"``,
``greedy_on_cpu``)."""

from functools import partial

import pytest

from test_torch_host_copies import load_twins

globals().update(load_twins(
    "test_property.py", {},
    edits={"    import jax.numpy as jnp\n": "    import torch as jnp\n"},
))


@pytest.fixture(autouse=True)
def greedy_on_cpu(monkeypatch):
    """Imports of the port's ``rank_match_placement`` inside a test's body
    get it with ``device="cpu"``."""
    from tpu_faas_torch.sched import greedy

    monkeypatch.setattr(greedy, "rank_match_placement",
                        partial(greedy.rank_match_placement, device="cpu"))


def test_twin_holds_the_ports_modules():
    assert MemoryStore.__module__ == "tpu_faas_torch.store.memory"
    assert RaceMonitor.__module__ == "tpu_faas_torch.store.racecheck"
    assert serialize.__module__ == "tpu_faas_torch.core.serialize"
