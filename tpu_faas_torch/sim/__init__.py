"""Simulated worker fleets driving the port's scheduler state."""

from tpu_faas_torch.sim.fleet import SimFleet, SimResult

__all__ = ["SimFleet", "SimResult"]
