"""Twins of tests/test_priority.py: the priority and cost hints through the
port's ``PendingTask``, gateway and client SDK; the port's rank admission
(``tpu_faas_torch.sched.greedy.rank_match_placement``) on torch tensors,
against the same plain-numpy oracle; and the priority ordering end to end
through the port's tpu-push dispatcher (``device="cpu"``) and push worker
process (``test_torch_host_copies.load_twins``). The file's ``jnp`` is
torch, whose ``ones``, ``zeros`` and ``asarray`` take the same arguments;
its ``rank_match_placement`` is the port's with ``device="cpu"``."""

from functools import partial

import torch

from test_torch_host_copies import check_ports_dispatcher, load_twins

from tpu_faas_torch.sched import greedy

globals().update(load_twins(
    "test_priority.py", {},
    overrides={"jnp": torch,
               "rank_match_placement": partial(greedy.rank_match_placement,
                                               device="cpu")},
    twins=("test_tpu_push_e2e", "test_workers_e2e"),
))


def test_twin_runs_the_ports_admission_and_dispatcher():
    assert rank_match_placement.func is greedy.rank_match_placement
    assert PendingTask.__module__ == "tpu_faas_torch.dispatch.base"
    check_ports_dispatcher(_make_dispatcher("memory://",
                                            recover_queued=False))
