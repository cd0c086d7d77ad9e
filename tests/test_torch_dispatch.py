"""The port's tpu-push dispatcher (``tpu_faas_torch/dispatch/``) as an
entry point: every attribute it reads on its scheduler exists there, the
tick runs on the card unless the caller asks for the CPU, a failed kernel
build stops it, the multi-device layouts build what they name, the
host-only modes (local, pull, push) start from the same CLI, and a flag
combination the CLI refuses fails at startup. Its service is held by the
twins (tests/test_torch_twin_tpu_push_e2e.py,
test_torch_twin_resident_e2e.py, test_torch_twin_multihost_dispatch_e2e.py:
the port's gateway and SDK, the JAX package's push workers) and by
tests/test_torch_host_processes.py (the port's own processes)."""

import ast
import os
import subprocess
import sys
import time

import pytest
import torch

from tpu_faas_torch.dispatch import __main__ as cli
from tpu_faas_torch.dispatch import tpu_push
from tpu_faas_torch.parallel import distributed
from tpu_faas_torch.parallel.multihost_resident import (
    MultihostResidentScheduler,
)
from tpu_faas_torch.parallel.multihost_tick import MultihostTick
from tpu_faas_torch.sched import bid, fused_tick
from tpu_faas_torch.sched.resident import ResidentScheduler
from tpu_faas_torch.sched.state import SchedulerArrays
from tpu_faas_torch.store import MemoryStore

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: reads on the scheduler that the port's classes do not carry, each with
#: the guard that keeps it from raising (none since the resident scheduler
#: reports its tick_backend)
ABSENT: dict[str, str] = {}


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
                 "device_dispatches_last_tick", "tick", "pending_add",
                 "lead_stop", "multihost"):
        assert name in reads, name
    kw = dict(max_workers=8, max_pending=16, max_inflight=32, max_slots=4,
              device="cpu")
    scheds = (SchedulerArrays(**kw), ResidentScheduler(**kw),
              MultihostResidentScheduler.from_shape(
                  time_to_expire=10.0, placement="rank", **kw))
    missing = sorted(n for n in reads - set(ABSENT)
                     if not any(hasattr(s, n) for s in scheds))
    assert not missing, missing
    assert set(ABSENT) <= reads
    for name in ABSENT:
        assert not any(hasattr(s, name) for s in scheds), name


def test_resident_tick_backend_names_b1_on_the_card():
    """The status block's tick_backend: ``fused_cuda`` where B1 serves the
    resident tick (a CUDA device), None on the CPU and for the batch
    tick."""
    kw = dict(max_workers=8, max_pending=16, max_inflight=32, max_slots=4,
              device="cpu")
    r = ResidentScheduler(**kw)
    assert r.tick_backend is None
    r.device = torch.device("cuda")  # what a card run holds; nothing runs
    assert r.tick_backend == "fused_cuda"
    assert not hasattr(SchedulerArrays(**kw), "tick_backend")


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
    on the CPU (the plain version) the flight record and the stats report
    None, and a resident tick counts its launches."""
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


@pytest.fixture
def alone(monkeypatch):
    """A process that has joined no group: initialize_multihost may run
    (and latch) inside the test without leaking into the next."""
    monkeypatch.setattr(distributed, "_state", {
        "initialized": False, "cpu_positions": None, "local_rank": 0})


@pytest.mark.parametrize("kw", [{"multihost": True},
                                {"multihost": True, "resident": True},
                                {"mesh_devices": 2},
                                {"mesh_devices": 2, "resident": True}])
def test_multi_device_layouts_raise_until_ported(alone, kw):
    """Each multi-device layout builds what it names and ticks (the name
    dates from when the port refused them). A multihost lead in a process
    that joined no group is a fleet of one."""
    d = _dispatcher(device="cpu", **kw)
    try:
        a = d.arrays
        assert isinstance(a, ResidentScheduler) == bool(kw.get("resident"))
        if kw.get("multihost") and kw.get("resident"):
            assert isinstance(a, MultihostResidentScheduler)
            assert a.multihost is None  # the packet protocol is its own
        elif kw.get("multihost"):
            assert isinstance(a.multihost, MultihostTick)
        else:
            assert a.mesh.size == 2 and a.max_pending == 8
            assert a.mesh.devices == [torch.device("cpu")] * 2
        d.tick()
        if kw.get("resident"):
            assert a.device_dispatches_last_tick == 1
    finally:
        d.socket.close(linger=0)


@pytest.mark.parametrize("argv,item", [
    (["-m", "tpu-push", "--multihost", "--mesh", "2"],
     "--multihost owns the global mesh; drop --mesh"),
])
def test_cli_refuses_what_is_not_ported(argv, item):
    with pytest.raises(SystemExit, match=item):
        cli.main(argv)


@pytest.mark.parametrize("argv,module,name", [
    (["-m", "local", "-w", "2"], "local", "LocalDispatcher"),
    (["-m", "pull", "-p", "0"], "pull", "PullDispatcher"),
    (["-m", "push", "-p", "0", "--hb", "--plb"], "push", "PushDispatcher"),
])
def test_cli_starts_the_host_modes(monkeypatch, argv, module, name):
    """``main`` builds the port's dispatcher of each host-only mode, with
    the flags passed on as JAX's CLI passes them, and reaches its serve
    loop (stubbed to return); ``--device`` is tpu-push's alone."""
    import importlib

    cls = getattr(importlib.import_module(
        f"tpu_faas_torch.dispatch.{module}"), name)
    built = []

    def serve(self, *a, **kw):
        built.append(self)
        return 0

    monkeypatch.setattr(cls, "start", serve)
    monkeypatch.setattr(cli, "_install_stop_signals", lambda d: None)
    cli.main([*argv, "--store", "memory://"])
    (d,) = built
    assert type(d).__module__ == f"tpu_faas_torch.dispatch.{module}"
    if module == "local":
        assert d.num_workers == 2
    else:
        d.socket.close(linger=0)
    if module == "push":
        assert d.heartbeat and d.process_lb


@pytest.mark.parametrize("argv", [
    ["--mesh", "2"],
    ["--mesh", "2", "--resident"],
    ["--multihost"],
    ["--multihost", "--resident"],
])
def test_cli_builds_the_multi_device_layouts(alone, monkeypatch, argv):
    """``main`` builds each layout (a multihost lead whose discovery found
    no group runs as a fleet of one, on gloo) and reaches the serve loop,
    which is stubbed to return."""
    built = []

    def serve(self, max_results=None):
        built.append(self)
        self.stop()
        return 0

    monkeypatch.setattr(tpu_push.TpuPushDispatcher, "start", serve)
    monkeypatch.setattr(cli, "_install_stop_signals", lambda d: None)
    cli.main(["-m", "tpu-push", "--device", "cpu", "-p", "0",
              "--store", "memory://", *argv])
    (d,) = built
    try:
        a = d.arrays
        assert isinstance(a, ResidentScheduler) == ("--resident" in argv)
        if "--mesh" in argv:
            assert a.mesh.size == 2
        elif "--resident" in argv:
            assert isinstance(a, MultihostResidentScheduler)
        else:
            assert isinstance(a.multihost, MultihostTick)
    finally:
        d.socket.close(linger=0)


@pytest.mark.parametrize("argv,message", [
    (["-m", "tpu-push", "--mesh", "2"],
     "no CUDA device is available"),
    (["-m", "tpu-push", "--multihost", "--mesh", "2"],
     "--multihost owns the global mesh; drop --mesh"),
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


@pytest.mark.parametrize("variant", ["raw", "raw-rcvbuf", "sndbuf",
                                     "concurrent", "drain"])
def test_busprobe_variants_count_every_announce(variant):
    """Each side of the bus the probe can change (ROADMAP C.5's split)
    still delivers every announce on the CPU."""
    from tpu_faas_torch.store import busprobe

    line = busprobe.run_in_thread(600, 200, False, 30.0, variant)
    assert line.startswith("600 of 600 announces"), line


def test_subscription_sets_its_receive_buffer_before_it_connects(
        monkeypatch):
    """ROADMAP C.5, outcome (a): the port's subscriber asks for an 8 MiB
    SO_RCVBUF on its socket BEFORE connect (the TCP window scale is fixed
    on the SYN), so an undrained burst of thousands of announces sits in
    the socket's buffer; a command connection keeps the defaults. A burst
    of 5,000 written before the first read then arrives whole."""
    import socket

    from tpu_faas_torch.store import client, launch

    handle = launch.start_store_thread()
    events: list = []
    real = socket.socket

    class Spy(real):
        def setsockopt(self, level, opt, value):
            if (level, opt) == (socket.SOL_SOCKET, socket.SO_RCVBUF):
                events.append((id(self), "rcvbuf", value))
            return super().setsockopt(level, opt, value)

        def connect(self, addr):
            events.append((id(self), "connect", addr[1]))
            return super().connect(addr)

    try:
        store = launch.make_store(handle.url)
        monkeypatch.setattr(client.socket, "socket", Spy)
        sub = store.subscribe("c5")
        monkeypatch.setattr(client.socket, "socket", real)
        mine = [e[1:] for e in events if e[0] == id(sub._conn.sock)]
        assert mine == [("rcvbuf", 8 << 20), ("connect", handle.port)]
        store.create_tasks([(f"c5-{i}", "F", "P") for i in range(5_000)],
                           "c5")
        got, deadline = 0, time.monotonic() + 30.0
        while got < 5_000 and time.monotonic() < deadline:
            got += sub.get_message(timeout=0.05) is not None
        assert got == 5_000
        sub.close()
        store.close()
    finally:
        handle.stop()


def _cli_flags(path: str) -> set[str]:
    """Every option string a CLI module's ``add_argument`` calls name."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    return {a.value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)
            and str(a.value).startswith("-")}


def test_cli_flags_are_jaxs_plus_device_and_dist_backend():
    """The port's dispatcher CLI takes every flag of JAX's, the
    multi-device ones included (--mesh, --multihost, --coordinator,
    --process-id, --num-processes, --cpu-pod-devices, --follower-watchdog),
    and two of its own."""
    want = _cli_flags(os.path.join(_REPO, "tpu_faas", "dispatch",
                                   "__main__.py"))
    got = _cli_flags(cli.__file__)
    assert {"--mesh", "--multihost", "--coordinator", "--process-id",
            "--num-processes", "--cpu-pod-devices",
            "--follower-watchdog"} <= want
    assert got == want | {"--device", "--dist-backend"}
