"""Twins of tests/test_resident_e2e.py: the port's ``TpuPushDispatcher``
with ``resident=True`` on the CPU (``device="cpu"``: the resident tick runs
B1's plain PyTorch version), behind the port's gateway and client SDK,
serving the JAX package's push worker processes, unmodified, through the
port's in-process store server (``test_torch_host_copies.load_twins``). The JAX tests build their
dispatchers with ``tests.test_tpu_push_e2e._make_dispatcher``, which is not
a ``tpu_faas`` import and would build the JAX dispatcher, so the twins get
the port's factory in its place."""

import pytest

import tests.test_tpu_push_e2e as jax_e2e
from test_torch_host_copies import check_ports_dispatcher, load_twins
from test_torch_twin_tpu_push_e2e import _make_dispatcher as _port_make

globals().update(load_twins("test_resident_e2e.py", {},
                            overrides={"_make_dispatcher": _port_make}))


@pytest.fixture(autouse=True)
def _port_factory_in_the_jax_module(monkeypatch):
    """test_resident_and_plain_shared_dispatchers_exactly_once imports the
    factory inside its body, from the JAX test module: patch it there for
    the twins of this file."""
    monkeypatch.setattr(jax_e2e, "_make_dispatcher", _port_make)


def test_twin_builds_the_ports_dispatcher():
    from tests.test_tpu_push_e2e import _make_dispatcher

    assert _make_dispatcher is _port_make
    assert _resident_stack.__globals__["_make_dispatcher"] is _port_make
    d = _port_make("memory://", resident=True, recover_queued=False)
    assert d.resident
    check_ports_dispatcher(d)
