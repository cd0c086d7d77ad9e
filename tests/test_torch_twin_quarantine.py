"""Twins of tests/test_quarantine.py against ``tpu_faas_torch/sched/
health.py`` and the port's dispatcher (``test_torch_host_copies.
load_twins``); the scheduler's health lanes are held against JAX in
tests/test_torch_spec.py. The place-cap and health-memory cases run the
port's ``SchedulerArrays`` on the CPU, the dispatcher cases the port's
``TpuPushDispatcher`` on the CPU."""

from functools import partial

import pytest

from test_torch_host_copies import (
    check_ports_dispatcher,
    dispatcher_on_cpu,
    load_twins,
)
from tpu_faas_torch.sched.state import SchedulerArrays

_TICK = "JAX's fused tick against its impl (the port's lane: " \
    "tests/test_torch_state.py)"
globals().update(load_twins("test_quarantine.py", {
    "test_place_cap_parity_fused_vs_impl": _TICK,
}, overrides=dict(SchedulerArrays=partial(SchedulerArrays, device="cpu"))))

_on_cpu = pytest.mark.usefixtures("dispatcher_on_cpu")
test_dispatcher_quarantine_enter_drain_release = _on_cpu(
    test_dispatcher_quarantine_enter_drain_release)
test_dispatcher_quarantine_off_is_inert = _on_cpu(
    test_dispatcher_quarantine_off_is_inert)
test_dispatcher_quarantine_refused_on_sharded_modes = _on_cpu(
    test_dispatcher_quarantine_refused_on_sharded_modes)
test_dispatcher_misfire_delta_feeds_health = _on_cpu(
    test_dispatcher_misfire_delta_feeds_health)


@_on_cpu
def test_twin_builds_the_ports_dispatcher():
    check_ports_dispatcher(_quarantine_dispatcher(lambda: 0.0))
