"""Twin of the tpu-push case of tests/test_reference_worker_interop.py: the
port's ``TpuPushDispatcher`` on the CPU (``device="cpu"``) serving the
reference's own push worker, unmodified, behind the JAX package's gateway
(``test_torch_host_copies.load_twins``). Like its original it skips where
the reference checkout is absent. The JAX test imports its factory from
``tests.test_tpu_push_e2e``, which would build the JAX dispatcher, so the
twin gets the port's factory in its place."""

import os

import pytest

from test_torch_host_copies import check_ports_dispatcher, load_twins
from test_torch_twin_tpu_push_e2e import _make_dispatcher as _port_make

_A12 = "drives the pull or push dispatcher, not ported yet (ROADMAP A.12)"
_REF = "runs the reference's own dispatcher: no dispatcher of the port"
_twin = load_twins("test_reference_worker_interop.py", {
    "pytestmark": "applied to the tpu-push twin alone, so that this "
    "file's check of the factory runs without the reference checkout",
    "test_reference_worker_interop_pull": _A12,
    "test_reference_worker_interop_push": _A12,
    "test_reference_worker_interop_push_heartbeat": _A12,
    "test_reference_worker_interop_mixed_fleet": _A12,
    "test_reference_worker_ignores_cancel": _A12,
    "test_reference_worker_crash_recovery": _A12,
    "test_reference_dispatcher_on_our_store": _REF,
    "test_reference_pull_dispatcher_on_our_store": _REF,
}, overrides={"_make_dispatcher": _port_make})

test_reference_worker_interop_tpu_push = pytest.mark.skipif(
    not os.path.isdir(_twin["REFERENCE_DIR"]),
    reason="reference checkout not present on this host",
)(_twin["test_reference_worker_interop_tpu_push"])


def test_twin_builds_the_ports_dispatcher():
    """``_ref_worker_stack("tpu_push", ...)`` reads the factory from the
    twin's namespace, where it is the port's."""
    make = _twin["test_reference_worker_interop_tpu_push"].__globals__[
        "_make_dispatcher"]
    assert make is _port_make
    check_ports_dispatcher(make("memory://", recover_queued=False))
