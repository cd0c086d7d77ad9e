"""Twins of tests/test_sim_fleet.py: the scaled-down configs 3-5 on the
port's ``SimFleet`` (``device="cpu"``) against the port's
``makespan_lower_bound`` (``test_torch_host_copies.load_twins``)."""

from functools import partial

from test_torch_host_copies import load_twins

from tpu_faas_torch.sim import SimFleet as _PortFleet

globals().update(load_twins(
    "test_sim_fleet.py", {},
    overrides={"SimFleet": partial(_PortFleet, device="cpu")},
))


def test_twin_runs_the_ports_fleet():
    import numpy as np

    fleet = SimFleet(n_workers=2, max_pending=8,
                     rng=np.random.default_rng(0))
    assert type(fleet).__module__ == "tpu_faas_torch.sim.fleet"
    assert fleet.arrays.device.type == "cpu"
    assert makespan_lower_bound.__module__ == "tpu_faas_torch.sched.oracle"
