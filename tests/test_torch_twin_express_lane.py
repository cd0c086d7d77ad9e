"""Twins of tests/test_express_lane.py: the inline result announce, the
gateway's long-poll, ``/results/wait`` and SSE contracts, and the SDK's
``wait_many`` against the port's store, gateway and client SDKs (sync and
asyncio), and the port's tpu-push dispatcher (``device="cpu"``) in express
mode serving the port's push worker process
(``test_torch_host_copies.load_twins`` with ``dispatcher_on_cpu``). The
tpu-push express case waits for the precondition its JAX original assumes
(``_hold_results_until_read``, ROADMAP C.12)."""

import time

import pytest

from test_torch_host_copies import (  # noqa: F401
    check_ports_dispatcher,
    cpu_dispatcher,
    dispatcher_on_cpu,
    load_twins,
)


def _hold_results_until_read(disp_store, gw_store, timeout: float = 2.0):
    """Setup of the tpu-push express case (ROADMAP C.12): the JAX case
    counts a result as served from the inline forward, which needs the
    client's long-poll parked at the gateway, its first store read done,
    before the dispatcher writes the result. Under load the whole round
    trip (about 10 ms) can end between the wait's arming and that read:
    the read then finds the result and serves it from the store, and the
    JAX case fails its count (logged as the JAX reference's behaviour).
    The twin holds each result write of the dispatcher's store until the
    gateway's store has read that task once (at most ``timeout``), so each
    wait is parked as the JAX case assumes; its assertions and bounds are
    the JAX case's."""
    read: set[str] = set()
    get = gw_store.get_result

    def get_result(task_id, *a, **k):
        out = get(task_id, *a, **k)
        read.add(task_id)
        return out

    def after_read(task_ids) -> None:
        deadline = time.monotonic() + timeout
        while (time.monotonic() < deadline
               and not all(t in read for t in task_ids)):
            time.sleep(0.0005)

    finish, finish_many = disp_store.finish_task, disp_store.finish_task_many

    def finish_task(task_id, *a, **k):
        after_read([task_id])
        return finish(task_id, *a, **k)

    def finish_task_many(items, *a, **k):
        after_read([it[0] for it in items])
        return finish_many(items, *a, **k)

    gw_store.get_result = get_result
    disp_store.finish_task = finish_task
    disp_store.finish_task_many = finish_task_many
    return disp_store


globals().update(load_twins(
    "test_express_lane.py", {}, twins=("test_workers_e2e",),
    overrides={"_hold_results_until_read": _hold_results_until_read},
    edits={
        "    gw_handle = start_gateway_thread(\n"
        "        make_store(store_handle.url), trace=True\n    )\n":
        "    gw_store = make_store(store_handle.url)\n"
        "    gw_handle = start_gateway_thread(gw_store, trace=True)\n",
        "        store=make_store(store_handle.url),\n":
        "        store=_hold_results_until_read(make_store(store_handle.url),\n"
        "                                       gw_store),\n",
    },
))
pytestmark = pytest.mark.usefixtures("dispatcher_on_cpu")


def test_twin_builds_the_ports_dispatcher():
    from tpu_faas_torch.dispatch.tpu_push import TpuPushDispatcher

    assert start_gateway_thread.__module__ == "tpu_faas_torch.gateway.app"
    assert AsyncFaaSClient.__module__ == "tpu_faas_torch.client.aio"
    check_ports_dispatcher(TpuPushDispatcher(
        ip="127.0.0.1", port=0, store=MemoryStore(), express=True))


def test_hold_results_until_read_waits_for_the_gateways_first_read():
    """The express case's setup (ROADMAP C.12): a result write of the
    dispatcher's store waits until the gateway's store has read that task
    once, and no longer than its timeout."""
    import threading

    from tpu_faas_torch.store import MemoryStore

    disp, gw = MemoryStore(), MemoryStore()
    _hold_results_until_read(disp, gw, timeout=5.0)
    done = threading.Event()
    writer = threading.Thread(target=lambda: (
        disp.finish_task("t0", "COMPLETED", "R", inline_max=4096),
        done.set()))
    writer.start()
    assert not done.wait(0.2)  # no read yet: the write waits
    gw.get_result("t0")
    assert done.wait(5.0)
    writer.join()
    t0 = time.monotonic()
    _hold_results_until_read(MemoryStore(), MemoryStore(), timeout=0.1)\
        .finish_task_many([("t1", "COMPLETED", "R", False)])
    assert 0.1 <= time.monotonic() - t0 < 2.0  # never read: the timeout
