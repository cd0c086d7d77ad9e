"""The harness: its parts found by name, its end-to-end metrics moved by a
stall in the window, a run without a card refused, nothing of JAX
loaded."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from benchmark import spec
from benchmark.guard import banned_modules
from benchmark.run import end_to_end

from small_cells import AUCTION, SINKHORN, run_small, small_cell

ROOT = spec.ROOT


def test_finds_parts_it_was_not_told_about(tmp_path):
    here = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "configs" / "fleet-new.json").write_text(
        json.dumps({"name": "fleet-new", "max_workers": 3}))
    (here / "traffic" / "burst-9.json").write_text(
        json.dumps({"name": "burst-9", "work_mean_s": 9.0}))
    (here / "metrics" / "new_layer_ms.part.py").write_text(textwrap.dedent(
        '''
        def read(ctx):
            return 2.0 * ctx["x"]
        '''))
    bench = {
        "workloads": [{"name": "fleet-new.burst-9", "config": "fleet-new",
                       "traffic": "burst-9", "chips": 1, "why": "test"}],
        "end_to_end": [{"name": "placed_per_s", "unit": "tasks/s"},
                       {"name": "other", "unit": "s",
                        "workloads": ["someone-else"]}],
        "per_layer": [{"name": "new_layer_ms.part", "unit": "ms"}],
    }
    cell = spec.find_cell("fleet-new.burst-9", bench, here=here)
    assert cell.config["max_workers"] == 3
    assert cell.traffic["work_mean_s"] == 9.0
    assert [m["name"] for m in cell.end_to_end] == ["placed_per_s"]
    reader = spec.metric_reader("new_layer_ms.part", here=here)
    assert reader.read({"x": 1.5}) == 3.0
    with pytest.raises(KeyError):
        spec.find_cell("fleet-new.other", bench, here=here)


def test_every_metric_has_a_reader_or_is_end_to_end():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        assert hasattr(spec.metric_reader(m["name"]), "read"), m["name"]
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]


def test_tick_tail_reader_is_the_end_to_end_tail():
    """``tick_p95_ms.host`` reads, from a window's stamps, the number the
    end-to-end ``tick_p95_ms`` reports."""
    from benchmark.context import Context

    cell = small_cell(SINKHORN)
    r = run_small(SINKHORN, 2**31 + 29, seconds=0.5)
    e2e = end_to_end(cell, r)["tick_p95_ms"]["value"]
    ctx = Context(cell.config, r["stamps"], r["ticks"], {}, None)
    assert spec.metric_reader("tick_p95_ms.host").read(ctx) == e2e
    empty = Context(cell.config, np.zeros((0, 4)), [], {}, None)
    assert spec.metric_reader("tick_p95_ms.host").read(empty) is None


def test_a_stall_moves_rate_and_tail(monkeypatch):
    from tpu_faas_torch.sched.resident import ResidentScheduler

    name, seed = SINKHORN, 2**31 + 23
    r = run_small(name, seed, seconds=1.5)
    base = end_to_end(small_cell(name), r)
    # every other tick of the window stalls four mean ticks (at least
    # 0.5 s), so the test holds however loaded the machine is
    tick_s = float(np.mean(r["tick_ms"])) / 1e3
    stall_s = max(0.5, 4 * tick_s)
    cfg = small_cell(name).config
    warmup = max(1, round(cfg["warmup_s"] / cfg["tick_period_s"]))
    real = ResidentScheduler.tick_resident
    calls = [0]

    def stalled(self, now=None):
        calls[0] += 1
        if calls[0] > warmup and calls[0] % 2 == 0:
            time.sleep(stall_s)
        return real(self, now)

    monkeypatch.setattr(ResidentScheduler, "tick_resident", stalled)
    slow = end_to_end(small_cell(name), run_small(
        name, seed, seconds=8 * (tick_s + stall_s / 2)))
    assert (slow["placed_per_s"]["value"]
            < 0.7 * base["placed_per_s"]["value"]), (base, slow)
    assert (slow["tick_p95_ms"]["value"]
            > base["tick_p95_ms"]["value"] + 500 * stall_s), (base, slow)


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(["-m", "benchmark.run", "--workload", AUCTION, "--seed",
              "2147483659", "--seconds", "1", "--trace", "0"], ROOT, env)
    assert p.returncode == 3, p.stderr
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr and "no result" in p.stderr


def test_bare_checkout_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: the program
    is missing, so a run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = textwrap.dedent(f'''
        import torch
        from benchmark import spec
        from benchmark.run import run_cell
        run_cell(spec.find_cell({AUCTION!r}), 1, 1.0, False,
                 torch.device("cpu"))
        print("{{}}")
        ''')
    p = _run(["-c", code], tmp_path)
    assert p.returncode != 0
    assert "tpu_faas_torch" in p.stderr
    assert p.stdout.strip() == ""


def test_guard_compares_whole_top_level_names():
    assert banned_modules(["jax.numpy", "tpu_faas.sched", "flax",
                           "tpu_faas_torch.sched", "jaxtyping",
                           "numpy"]) == ["flax", "jax", "tpu_faas"]
    assert banned_modules(["tpu_faas_torch", "tpu_faas_torch.bench"]) == []


def test_nothing_the_benchmark_runs_imports_jax():
    """In a fresh interpreter: every module of the benchmark imported and
    a small cell of each placement run on the CPU, then no module whose
    top-level name is jax, jaxlib, flax or tpu_faas is loaded."""
    mods = sorted(
        "benchmark." + str(p.relative_to(ROOT / "benchmark"))[:-3]
        .replace(os.sep, ".")
        for p in (ROOT / "benchmark").rglob("*.py")
        if "tests" not in p.parts and p.name != "__init__.py"
        and "metrics" not in p.parts)
    code = textwrap.dedent(f'''
        import importlib, json, sys
        sys.path.insert(0, {str(ROOT / "benchmark" / "tests")!r})
        for m in {mods!r}:
            importlib.import_module(m)
        from benchmark import spec
        for m in spec.load_benchmark()["per_layer"]:
            spec.metric_reader(m["name"])
        from small_cells import run_small, AUCTION, SINKHORN, RANK_CHURN
        for name in (AUCTION, SINKHORN, RANK_CHURN):
            assert run_small(name, seconds=1.0)["verdict"].correct
        from benchmark.guard import banned_modules
        print(json.dumps(banned_modules()))
        ''')
    p = _run(["-c", code], ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_trace_reads_spans_and_idle_gaps():
    from benchmark import trace as tracing

    r = run_small(SINKHORN, seconds=0.5, trace=True)
    cap = tracing.capture(r["events"], len(r["ticks"]))
    assert cap is not None and len(cap.spans) == len(r["ticks"])
    # on the CPU nothing runs on a device: the whole window is idle,
    # and most of it inside the ticks' spans
    gaps = dict(cap.idle_gaps())
    assert abs(sum(gaps.values()) - cap.window_s) < 1e-6 * max(
        1.0, cap.window_s)
    assert gaps["bench.enqueue"] > gaps.get("between", 0.0)
    stamps = r["stamps"]
    host = float(np.sum(stamps[:, 3] - stamps[:, 0]))
    assert abs(sum(e - s for t in cap.spans for s, e in t) - host) < (
        0.2 * host)
