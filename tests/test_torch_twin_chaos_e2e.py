"""Twins of tests/test_chaos_e2e.py: SIGKILLed workers, store restarts and
dispatcher crashes against the port's stack. The dispatcher a case kills
is ``python -m tpu_faas_torch.dispatch -m tpu-push --device cpu`` (the
JAX file's launcher, pointed at the port's entry point); the in-process
dispatchers are the port's ``TpuPushDispatcher`` (``device="cpu"``) and
``PullDispatcher``; the workers are the port's processes
(``test_torch_host_copies.load_twins``). ``cpu_worker_env`` is read from
the JAX package's ``bench/``, which the port does not have: it only builds
an environment dict."""

import os
import subprocess
import sys
import time

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
    reserved_port,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_dispatcher(port: int, store_url: str, *extra: str):
    """The JAX file's launcher, for the port's CLI on the CPU."""
    from tpu_faas.bench.harness import cpu_worker_env

    env = cpu_worker_env()
    # one intra-op thread a dispatcher: the suite's workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [
            sys.executable, "-m", "tpu_faas_torch.dispatch",
            "-m", "tpu-push", "--device", "cpu", "-p", str(port),
            "-i", "127.0.0.1", "--store", store_url, "--rescan", "0.5",
            "--tte", "2.0",
        ]
        + list(extra),
        env=env,
        cwd=REPO,
    )


def _await_pull_workers(disp, n: int, holding: bool,
                        timeout: float = 120.0) -> None:
    """Setup of the pull case (ROADMAP C.10): wait until ``n`` pull workers
    have sent ``disp`` their first request, and with ``holding`` until each
    of them holds a task. The JAX case kills ``workers[0]`` once any two
    tasks run; under load both can run on ``workers[1]`` before
    ``workers[0]``'s first request, and then nothing is reclaimed. The
    twin waits for each worker first (before the submits, and before the
    kill); its assertions and bounds are the JAX case's."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        held = [len(ts) for ts in list(disp.worker_tasks.values())]
        if len(list(disp.last_seen)) >= n and (
                not holding or (len(held) >= n and all(held))):
            return
        time.sleep(0.05)
    raise AssertionError(f"{n} pull workers never "
                         f"{'held a task each' if holding else 'registered'}")


# the dispatcher's port lies below the ephemeral range (reserved_port): a
# bind(0) port could be taken before the respawned child binds it; the pull
# case waits for each worker before its submits and its kill
globals().update(load_twins(
    "test_chaos_e2e.py", {},
    overrides={"TpuPushDispatcher": cpu_dispatcher(),
               "_spawn_dispatcher": _spawn_dispatcher,
               "_free_port": reserved_port,
               "_await_pull_workers": _await_pull_workers},
    twins=("test_workers_e2e",),
    edits={
        "        handles = [client.submit(fid, 0.8) for _ in range(8)]\n":
        "        _await_pull_workers(disp, 2, holding=False)\n"
        "        handles = [client.submit(fid, 0.8) for _ in range(8)]\n",
        "            raise AssertionError(\"tasks never started on the pull "
        "fleet\")\n":
        "            raise AssertionError(\"tasks never started on the pull "
        "fleet\")\n        _await_pull_workers(disp, 2, holding=True)\n",
    },
))


def test_twin_builds_the_ports_dispatcher():
    import test_torch_twin_workers_e2e as port_workers
    from tpu_faas_torch.store.memory import MemoryStore

    assert _spawn_worker is port_workers._spawn_worker
    check_ports_dispatcher(TpuPushDispatcher(ip="127.0.0.1", port=0,
                                             store=MemoryStore()))
