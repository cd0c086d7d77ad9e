"""Twins of tests/test_store_memory.py, tests/test_store_resp.py and
tests/test_store_snapshot.py against ``tpu_faas_torch/store``
(``test_torch_host_copies.load_twins``): the in-process servers only; the
cases that start the native store as a process are left out."""

import pytest

from test_torch_host_copies import load_twins, only_params
from tpu_faas_torch.store.launch import start_store_thread

_NATIVE = "starts the native store process"
globals().update(load_twins("test_store_memory.py", {}))
globals().update(load_twins("test_store_resp.py", {}))
globals().update(load_twins("test_store_snapshot.py", {
    "test_native_server_restart_resumes": _NATIVE,
    "test_cross_server_snapshot_compat": _NATIVE,
    "test_python_server_shutdown_exits_despite_attached_subscriber":
        "starts a server process",
}))
test_info_command = only_params(test_info_command, "kind", ["python"])
test_pipeline_one_round_trip_semantics = only_params(
    test_pipeline_one_round_trip_semantics, "kind", ["python"])


@pytest.fixture
def store_server():
    """The contract suite against the port's asyncio server, in-process."""
    handle = start_store_thread()
    yield handle
    handle.stop()
