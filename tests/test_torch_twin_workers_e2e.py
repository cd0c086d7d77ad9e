"""Twins of tests/test_workers_e2e.py: the port's pull and push
dispatchers serving the port's worker processes (``python -m
tpu_faas_torch.worker.pull_worker|push_worker``) behind the port's gateway
and store server, driven by the port's client SDK
(``test_torch_host_copies.load_twins``; the worker module string of
``_spawn_worker`` is pointed at the port)."""

import time

from test_torch_host_copies import load_twins

globals().update(load_twins("test_workers_e2e.py", {},
                            processes=("tpu_faas.worker.",)))


def test_twin_spawns_the_ports_workers():
    """``_spawn_worker`` starts the port's worker modules, and the
    dispatchers are the port's."""
    assert PullDispatcher.__module__ == "tpu_faas_torch.dispatch.pull"
    assert PushDispatcher.__module__ == "tpu_faas_torch.dispatch.push"
    for kind in ("pull_worker", "push_worker"):
        # no dispatcher listens there: the worker waits, and is killed
        w = _spawn_worker(kind, 1, "tcp://127.0.0.1:9")
        try:
            time.sleep(0.1)
            with open(f"/proc/{w.pid}/cmdline", "rb") as fh:
                argv = fh.read().decode().split("\0")
            assert argv[argv.index("-m") + 1] == (
                f"tpu_faas_torch.worker.{kind}")
        finally:
            w.kill()
            w.wait()
