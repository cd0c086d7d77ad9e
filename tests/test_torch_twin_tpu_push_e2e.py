"""Twins of tests/test_tpu_push_e2e.py: the port's ``TpuPushDispatcher``
(``tpu_faas_torch/dispatch/tpu_push.py``) on the CPU, ``device="cpu"``,
behind the port's gateway and client SDK, serving the JAX package's push
worker processes (the JAX file's own launcher), unmodified, through the
port's in-process store server and store client
(``test_torch_host_copies.load_twins``). One case also runs against the
JAX package's own store server. The
mesh case serves over 8 CPU positions (``mesh_devices=8``)."""

from test_torch_host_copies import (
    check_ports_dispatcher,
    cpu_dispatcher,
    load_twins,
)

globals().update(load_twins("test_tpu_push_e2e.py", {},
                            overrides={"TpuPushDispatcher": cpu_dispatcher()}))

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
    """The mesh dispatcher builds its 8 CPU positions (the name dates from
    when the port refused the layout)."""
    d = _make_dispatcher("memory://", mesh_devices=8, recover_queued=False)
    assert d.arrays.mesh.size == 8
    assert d.arrays.max_pending % 8 == 0
    check_ports_dispatcher(d)
