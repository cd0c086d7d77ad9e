"""The port's tpu-push dispatcher (``tpu_faas_torch/dispatch/``) as an
entry point: every attribute it reads on its scheduler exists there, the
tick runs on the card unless the caller asks for the CPU, a failed kernel
build stops it, and the modes and layouts that are not ported yet fail at
startup with the ROADMAP item they wait for. Its service against the JAX
gateway and workers is held by the twins
(tests/test_torch_twin_tpu_push_e2e.py, test_torch_twin_resident_e2e.py)."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from tpu_faas_torch.dispatch import __main__ as cli
from tpu_faas_torch.dispatch import tpu_push
from tpu_faas_torch.sched import bid, fused_tick
from tpu_faas_torch.sched.resident import ResidentScheduler
from tpu_faas_torch.sched.state import SchedulerArrays
from tpu_faas_torch.store import MemoryStore

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: reads on the scheduler that the port's classes do not carry, each with
#: the guard that keeps it from raising
ABSENT = {
    "tick_backend": "read through getattr(..., None); the port reports None",
    "lead_stop": "read only where hasattr(self.arrays, 'lead_stop') holds: "
    "the multihost lead's, ROADMAP A.11",
}


def _arrays_reads() -> set[str]:
    """Every attribute ``dispatch/tpu_push.py`` reads on ``self.arrays``
    or on a local alias of it (``a = self.arrays``), directly or through
    ``getattr``/``hasattr`` with a constant name."""
    tree = ast.parse(open(tpu_push.__file__, encoding="utf-8").read())

    def is_arrays(n):
        return (isinstance(n, ast.Attribute) and n.attr == "arrays"
                and isinstance(n.value, ast.Name) and n.value.id == "self")

    reads = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        aliases = {t.id for n in ast.walk(fn) if isinstance(n, ast.Assign)
                   and is_arrays(n.value)
                   for t in n.targets if isinstance(t, ast.Name)}

        def on_arrays(n):
            return is_arrays(n) or (isinstance(n, ast.Name)
                                    and n.id in aliases)

        for n in ast.walk(fn):
            if isinstance(n, ast.Attribute) and on_arrays(n.value):
                reads.add(n.attr)
            elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                  and n.func.id in ("getattr", "hasattr")
                  and len(n.args) >= 2 and on_arrays(n.args[0])
                  and isinstance(n.args[1], ast.Constant)):
                reads.add(n.args[1].value)
    return reads


def test_every_scheduler_read_exists_on_the_ports_scheduler():
    reads = _arrays_reads()
    for name in ("tick_resident", "resolve_next", "note_misfire",
                 "recall_health", "_inflight_slot", "tenant_deficits",
                 "inflight_owner", "worker_speed",
                 "device_dispatches_last_tick", "tick", "pending_add"):
        assert name in reads, name
    kw = dict(max_workers=8, max_pending=16, max_inflight=32, max_slots=4,
              device="cpu")
    scheds = (SchedulerArrays(**kw), ResidentScheduler(**kw))
    missing = sorted(n for n in reads - set(ABSENT)
                     if not any(hasattr(s, n) for s in scheds))
    assert not missing, missing
    assert set(ABSENT) <= reads
    for name in ABSENT:
        assert not any(hasattr(s, name) for s in scheds), name


def _dispatcher(**kw):
    return tpu_push.TpuPushDispatcher(
        ip="127.0.0.1", port=0, store=MemoryStore(), max_workers=4,
        max_pending=8, max_inflight=16, recover_queued=False, **kw)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("kw", [{}, {"device": "cuda"},
                                {"device": "cuda", "resident": True}])
def test_dispatcher_raises_without_a_gpu(no_gpu, kw):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _dispatcher(**kw)


@pytest.mark.parametrize("resident,placement,kernel", [
    (True, "rank", fused_tick.KERNEL),
    (True, "auction", fused_tick.KERNEL),
    (False, "auction", bid.KERNEL),
])
def test_a_failed_kernel_build_stops_the_dispatcher(
        monkeypatch, resident, placement, kernel):
    """On CUDA the constructor builds the tick's kernel before it opens the
    store or the socket; a build that fails raises there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def fail():
        raise RuntimeError("CUDA build of the kernel failed: nvcc exited 1")

    monkeypatch.setattr(kernel, "load", fail)
    with pytest.raises(RuntimeError, match="nvcc exited 1"):
        _dispatcher(resident=resident, placement=placement)


def test_cpu_dispatcher_builds_no_kernel(monkeypatch):
    def fail():
        raise AssertionError("a kernel was built for the CPU")

    monkeypatch.setattr(fused_tick.KERNEL, "load", fail)
    monkeypatch.setattr(bid.KERNEL, "load", fail)
    for kw in ({"resident": True}, {"placement": "auction"}):
        d = _dispatcher(device="cpu", **kw)
        d.socket.close(linger=0)


@pytest.mark.parametrize("resident", [False, True])
def test_tick_backend_is_accepted_and_reported_none(resident):
    """JAX's keyword binds; the port's scheduler has no backend to pick, so
    the flight record and the stats report None, and a resident tick
    counts its launches."""
    d = _dispatcher(device="cpu", resident=resident, tick_backend="fused")
    try:
        d.tick()
        assert d._flightrec_tick_extra()["tick_backend"] is None
        stats = d.stats()
        assert stats["tick_backend"] is None
        want = 1 if resident else None
        assert stats["device_dispatches_last_tick"] == want
    finally:
        d.socket.close(linger=0)


@pytest.mark.parametrize("kw", [{"multihost": True},
                                {"multihost": True, "resident": True},
                                {"mesh_devices": 2},
                                {"mesh_devices": 2, "resident": True}])
def test_multi_device_layouts_raise_until_ported(kw):
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.11"):
        _dispatcher(device="cpu", **kw)


@pytest.mark.parametrize("argv,item", [
    (["-m", "tpu-push", "--mesh", "2"], "mesh is not ported .* A.11"),
    (["-m", "tpu-push", "--multihost"], "multihost is not ported .* A.11"),
    (["-m", "tpu-push", "--resident", "--multihost", "--process-id", "1"],
     "multihost is not ported .* A.11"),
    (["-m", "pull"], "'pull' is not ported yet: ROADMAP A.12"),
    (["-m", "push", "--hb"], "'push' is not ported yet: ROADMAP A.12"),
    (["-m", "local", "-w", "2"], "'local' is not ported yet: ROADMAP A.12"),
])
def test_cli_refuses_what_is_not_ported(argv, item):
    with pytest.raises(SystemExit, match=item):
        cli.main(argv)


@pytest.mark.parametrize("argv,message", [
    (["-m", "tpu-push", "--mesh", "2"],
     "mesh is not ported to tpu_faas_torch yet: ROADMAP A.11"),
    (["-m", "tpu-push", "--multihost"],
     "multihost is not ported to tpu_faas_torch yet: ROADMAP A.11"),
    (["-m", "pull"], "'pull' is not ported yet: ROADMAP A.12"),
])
def test_module_entry_point_refuses_what_is_not_ported(argv, message):
    out = subprocess.run(
        [sys.executable, "-m", "tpu_faas_torch.dispatch", *argv],
        cwd=_REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode != 0
    assert message in out.stderr


@pytest.mark.parametrize("late", [False, True])
def test_busprobe_counts_every_announce(late):
    from tpu_faas_torch.store import busprobe, launch

    handle = launch.start_store_thread()
    try:
        line = busprobe.probe(handle.url, tasks=300, chunk=100, late=late,
                              limit=30.0)
    finally:
        handle.stop()
    assert line.startswith("300 of 300 announces"), line
    assert ("after the last" if late else "after each") in line
