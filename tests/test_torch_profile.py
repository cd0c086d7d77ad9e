"""The port's tick profiler on ``torch.profiler``: the env-gated capture
of the first N ticks, each in its own span, and the reading of a capture
back as each tick's device operations."""

import json

import pytest
import torch

from tpu_faas_torch.obs import MetricsRegistry, render
from tpu_faas_torch.obs.profile import (
    PROFILE_DIR_ENV,
    PROFILE_TICKS_ENV,
    TICK_SPAN,
    TickProfiler,
    device_ops_by_tick,
    tick_spans,
)


def test_env_names_carry_no_jax():
    assert "JAX" not in PROFILE_DIR_ENV and "JAX" not in PROFILE_TICKS_ENV


def test_capture_writes_the_first_ticks_in_spans(tmp_path, monkeypatch):
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(PROFILE_TICKS_ENV, "3")
    p = TickProfiler(MetricsRegistry())
    x = torch.arange(64, dtype=torch.float32)
    for _ in range(5):
        with p.tick_capture():
            x = (x * 2).sort().values
    assert p.trace_path is not None and p.trace_path.startswith(str(tmp_path))
    with open(p.trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = [e for e in events if e.get("name") == TICK_SPAN
             and e.get("cat") == "user_annotation"]
    assert len(spans) == 3  # the budget, then no-ops
    # a CPU capture holds no device operations
    assert device_ops_by_tick(p.trace_path) == [[], [], []]
    p.close()


def test_capture_off_without_the_env(monkeypatch):
    monkeypatch.delenv(PROFILE_DIR_ENV, raising=False)
    p = TickProfiler(MetricsRegistry())
    with p.tick_capture():
        pass
    assert p.trace_path is None and not p._tracing


def test_signature_counting_and_series_names():
    reg = MetricsRegistry()
    p = TickProfiler(reg)
    sig = ("rank", 64, 16, 4)
    assert p.observe_shape(tasks=64, workers=16, slots=4, signature=sig)
    assert not p.observe_shape(tasks=64, workers=16, slots=4, signature=sig)
    p.note_device_dispatches(2)
    text = render([reg])
    for series in ("tpu_faas_jit_recompiles_total 1",
                   'tpu_faas_tick_shape{dim="tasks"} 64',
                   "tpu_faas_device_ticks_total 2",
                   "tpu_faas_tick_device_dispatches_last 2",
                   "tpu_faas_tick_device_dispatches_total 2"):
        assert series in text, series
    assert p.n_signatures == 1


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_device_ops_group_by_the_span_that_launched_them(tmp_path):
    """An operation belongs to the tick whose span issued its launch (the
    runtime call's correlation id), even when it runs after the span has
    closed on the host; launches outside every span are left out."""
    events = [
        _ev("user_annotation", TICK_SPAN, 100.0, 50.0),
        _ev("user_annotation", TICK_SPAN, 300.0, 50.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0, corr=1),
        _ev("cuda_runtime", "cudaMemcpyAsync", 120.0, 5.0, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 310.0, 5.0, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 200.0, 5.0, corr=4),
        _ev("kernel", "fused_rank_kernel", 400.0, 40.0, corr=1),
        _ev("gpu_memcpy", "Memcpy HtoD", 150.0, 10.0, corr=2),
        _ev("kernel", "fused_rank_kernel", 500.0, 40.0, corr=3),
        _ev("kernel", "other", 250.0, 5.0, corr=4),
        _ev("cpu_op", "aten::sort", 105.0, 1.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    ticks = device_ops_by_tick(str(path))
    assert [[e["name"] for e in ops] for ops in ticks] == [
        ["Memcpy HtoD", "fused_rank_kernel"], ["fused_rank_kernel"],
    ]
    assert tick_spans(str(path)) == [(100.0, 150.0), (300.0, 350.0)]


@pytest.mark.parametrize("budget", ["0", "bogus"])
def test_capture_budget_zero_or_malformed_is_off(tmp_path, monkeypatch,
                                                 budget):
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path))
    monkeypatch.setenv(PROFILE_TICKS_ENV, budget)
    p = TickProfiler(MetricsRegistry())
    with p.tick_capture():
        pass
    assert p.trace_path is None
