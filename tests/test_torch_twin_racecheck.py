"""Twins of tests/test_racecheck.py against ``tpu_faas_torch/store/
racecheck.py`` (``test_torch_host_copies.load_twins``). The one case that
drives a dispatcher runs the port's ``LocalDispatcher`` over the port's
``MemoryStore`` wrapped in the port's ``RaceCheckStore``."""

from test_torch_host_copies import load_twins

globals().update(load_twins("test_racecheck.py", {}))


def test_twin_runs_the_ports_race_monitor():
    assert RaceCheckStore.__module__ == "tpu_faas_torch.store.racecheck"
    assert RaceMonitor.__module__ == "tpu_faas_torch.store.racecheck"
    assert MemoryStore.__module__ == "tpu_faas_torch.store.memory"
    assert LocalDispatcher.__module__ == "tpu_faas_torch.dispatch.local"
