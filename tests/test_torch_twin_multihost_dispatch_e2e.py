"""Twins of tests/test_multihost_dispatch_e2e.py: two ``python -m
tpu_faas_torch.dispatch -m tpu-push --multihost`` processes of the port
(gloo, 4 CPU positions each, ``--device cpu``) form one fleet; the lead
serves behind the port's gateway and client SDK, through the port's store
server, with the JAX package's push workers, every tick (batch) or packet
(``--resident``) collective across both; a SIGTERM to the lead releases the follower
through the stop broadcast. ``_spawn_dispatcher`` is the port's in the
JAX tests' bodies (``test_torch_host_copies.load_twins``).

``--mesh 2`` (with and without ``--resident``) starts through the same
entry point in one process and serves the same stack."""

import os
import signal
import subprocess
import sys

import pytest

from test_torch_host_copies import load_twins, reserved_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cli(*args: str):
    from tpu_faas.bench.harness import cpu_worker_env

    env = cpu_worker_env()
    env.pop("XLA_FLAGS", None)
    # one intra-op thread a dispatcher: the suite's workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_faas_torch.dispatch", "-m", "tpu-push",
         "--device", "cpu", "-i", "127.0.0.1", *args],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True,
    )


def _spawn_dispatcher(rank: int, coord: int, zmq_port: int, store_url: str,
                      *extra: str):
    """The JAX file's lead/follower launcher, for the port's CLI."""
    return _port_cli(
        "-p", str(zmq_port), "--multihost",
        "--coordinator", f"127.0.0.1:{coord}",
        "--process-id", str(rank), "--num-processes", "2",
        "--cpu-pod-devices", "4", "--max-pending", "64",
        "--max-fleet", "16", "--tick-period", "0.05", "--tte", "2.0",
        "--follower-watchdog", "240", "--store", store_url, *extra,
    )


# the coordinator's and the sockets' ports lie below the ephemeral range
# (reserved_port): a bind(0) port could be taken before a child binds it
globals().update(load_twins("test_multihost_dispatch_e2e.py", {},
                            overrides={"_spawn_dispatcher":
                                       _spawn_dispatcher,
                                       "_free_port": reserved_port}))


@pytest.mark.parametrize("resident", [False, True])
def test_mesh_dispatcher_cli_serves_and_stops(resident):
    """``--mesh 2 --device cpu`` from the command line: the port's
    dispatcher shards its tick (or, resident, runs B1's plain version on
    the whole state) over 2 positions, serves 8 tasks through a JAX push
    worker, and exits 0 on SIGTERM."""
    store_handle = start_store_thread()
    gw = start_gateway_thread(make_store(store_handle.url))
    zmq_port = _free_port()
    disp = _port_cli("-p", str(zmq_port), "--mesh", "2", "--max-pending",
                     "30", "--tick-period", "0.02", "--store",
                     store_handle.url, *(["--resident"] if resident else []))
    worker = None
    try:
        worker = _spawn_worker("push_worker", 2,
                               f"tcp://127.0.0.1:{zmq_port}", "--hb",
                               "--hb-period", "0.3")
        client = FaaSClient(gw.url)
        fid = client.register(lambda x: 3 * x + 1, name="affine")
        handles = [client.submit(fid, i) for i in range(8)]
        assert [h.result(timeout=120.0) for h in handles] == [
            3 * i + 1 for i in range(8)]
        os.kill(disp.pid, signal.SIGTERM)
        out, _ = disp.communicate(timeout=60)
        assert disp.returncode == 0, out[-2000:]
    finally:
        if worker is not None and worker.poll() is None:
            worker.kill()
            worker.wait()
        if disp.poll() is None:
            disp.kill()
            disp.wait()
        gw.stop()
        store_handle.stop()
