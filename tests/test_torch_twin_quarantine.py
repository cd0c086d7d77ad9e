"""Twins of the ``QuarantineBook`` part of tests/test_quarantine.py against
``tpu_faas_torch/sched/health.py`` (``test_torch_host_copies.load_twins``);
the scheduler's health lanes are held against JAX in
tests/test_torch_spec.py, and the dispatcher cases come with the
dispatcher. The place-cap and health-memory cases run the port's
``SchedulerArrays`` on the CPU."""

from functools import partial

from test_torch_host_copies import load_twins
from tpu_faas_torch.sched.state import SchedulerArrays

_TICK = "JAX's fused tick against its impl (the port's lane: " \
    "tests/test_torch_state.py)"
_DISPATCHER = "drives a dispatcher"
globals().update(load_twins("test_quarantine.py", {
    "test_place_cap_parity_fused_vs_impl": _TICK,
    "test_place_cap_refused_on_sharded_fleets":
        "mesh layouts are not ported (ROADMAP A.11)",
    "test_dispatcher_quarantine_enter_drain_release": _DISPATCHER,
    "test_dispatcher_quarantine_off_is_inert": _DISPATCHER,
    "test_dispatcher_quarantine_refused_on_sharded_modes": _DISPATCHER,
    "test_dispatcher_misfire_delta_feeds_health": _DISPATCHER,
}, overrides=dict(SchedulerArrays=partial(SchedulerArrays, device="cpu"))))
