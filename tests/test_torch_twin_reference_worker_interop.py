"""Twins of tests/test_reference_worker_interop.py: the port's pull, push
and tpu-push (``device="cpu"``) dispatchers serving the reference's own
workers, unmodified, behind the port's gateway
(``test_torch_host_copies.load_twins``). Like their originals they skip
where the reference checkout is absent. The JAX test imports its
dispatcher factory from ``tests.test_tpu_push_e2e`` and its worker
launcher from ``tests.test_workers_e2e``, which would build the JAX
dispatcher and start the JAX workers, so the twin gets the port's in their
place; the reference's processes import redis-py's surface from the port's
shim (``SHIM_DIR``, ``tpu_faas_torch/compat/redis_shim``)."""

import os

import pytest

from test_torch_host_copies import _PORT, check_ports_dispatcher, load_twins
from test_torch_twin_tpu_push_e2e import _make_dispatcher as _port_make
from test_torch_twin_workers_e2e import _spawn_worker as _port_spawn

_REF = "runs the reference's own dispatcher: no dispatcher of the port"
_twin = load_twins("test_reference_worker_interop.py", {
    "pytestmark": "applied to each twin instead, so that this file's "
    "check of the factories runs without the reference checkout",
    "test_reference_dispatcher_on_our_store": _REF,
    "test_reference_pull_dispatcher_on_our_store": _REF,
}, overrides={"_make_dispatcher": _port_make, "_spawn_worker": _port_spawn,
              "SHIM_DIR": os.path.join(_PORT, "compat", "redis_shim")})

_needs_reference = pytest.mark.skipif(
    not os.path.isdir(_twin["REFERENCE_DIR"]),
    reason="reference checkout not present on this host",
)
globals().update({name: _needs_reference(fn) for name, fn in _twin.items()
                  if name.startswith("test_")})


def test_twin_builds_the_ports_dispatcher():
    """``_ref_worker_stack`` reads the factories from the twin's namespace,
    where they are the port's."""
    g = _twin["test_reference_worker_interop_tpu_push"].__globals__
    assert g["_make_dispatcher"] is _port_make
    assert g["_spawn_worker"] is _port_spawn
    assert g["SHIM_DIR"] == os.path.join(_PORT, "compat", "redis_shim")
    assert os.path.isfile(os.path.join(g["SHIM_DIR"], "redis", "__init__.py"))
    assert g["PullDispatcher"].__module__ == "tpu_faas_torch.dispatch.pull"
    assert g["PushDispatcher"].__module__ == "tpu_faas_torch.dispatch.push"
    check_ports_dispatcher(_port_make("memory://", recover_queued=False))
