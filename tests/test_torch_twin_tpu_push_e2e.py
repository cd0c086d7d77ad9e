"""Twins of tests/test_tpu_push_e2e.py: the port's ``TpuPushDispatcher``
(``tpu_faas_torch/dispatch/tpu_push.py``) on the CPU, ``device="cpu"``,
serving the JAX package's gateway, client SDK and push worker processes,
unmodified, through the port's in-process store server and store client
(``test_torch_host_copies.load_twins``). One case also runs against the
JAX package's own store server and the gateway's own store client.

The mesh case is left out: multi-device layouts are not ported (ROADMAP
A.11); ``test_mesh_dispatcher_raises_until_ported`` pins what the port
does instead."""

import pytest

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)

globals().update(load_twins("test_tpu_push_e2e.py", {
    "test_tpu_push_mesh_dispatcher_e2e":
        "mesh layouts are not ported (ROADMAP A.11)",
}, overrides={"TpuPushDispatcher": cpu_dispatcher()}))

# the end-to-end case again, with the JAX package's store server and the
# gateway's own store client; the dispatcher keeps the port's client
test_tpu_push_end_to_end_on_the_jax_store = load_twins(
    "test_tpu_push_e2e.py", {}, keep=("tpu_faas.store.launch",),
    overrides={"_make_dispatcher": _make_dispatcher},
)["test_tpu_push_end_to_end"]


def test_twin_builds_the_ports_dispatcher():
    d = _make_dispatcher("memory://", recover_queued=False)
    assert type(d.store).__module__ == "tpu_faas_torch.store.memory"
    check_ports_dispatcher(d)


def test_mesh_dispatcher_raises_until_ported():
    with pytest.raises(NotImplementedError, match="A.11"):
        _make_dispatcher("memory://", mesh_devices=8, recover_queued=False)
