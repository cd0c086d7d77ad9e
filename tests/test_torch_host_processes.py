"""The port's host processes on their own: the gateway, the workers and
their pool, the supervisor, the client and the host-only dispatcher modes
load none of torch, JAX or the JAX package (a fresh interpreter each);
then the whole stack as separate processes through the port's entry
points on the CPU (``chip_smoke.stack_run``, the card run's ``stack``
phase at a small size): store server, gateway, ``-m tpu-push --resident
--device cpu`` with one push worker serving 16 calls through the port's
SDK, then ``-m local``, ``-m pull`` and ``-m push --hb`` serving 8 each."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: what a host process imports: none may load a device library
HOST_MODULES = (
    "tpu_faas_torch.gateway", "tpu_faas_torch.gateway.app",
    "tpu_faas_torch.gateway.__main__",
    "tpu_faas_torch.worker.push_worker", "tpu_faas_torch.worker.pull_worker",
    "tpu_faas_torch.worker.deploy", "tpu_faas_torch.worker.pool",
    "tpu_faas_torch.client", "tpu_faas_torch.client.aio",
    "tpu_faas_torch.dispatch.local", "tpu_faas_torch.dispatch.pull",
    "tpu_faas_torch.dispatch.push", "tpu_faas_torch.dispatch.__main__",
    "tpu_faas_torch.store.server",
)

_CHECK = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("torch", "jax", "jaxlib", "tpu_faas"))
assert sys.argv[1] in sys.modules
print("LOADED", bad[:8])
assert not bad, bad
"""


@pytest.mark.parametrize("module", HOST_MODULES)
def test_host_module_loads_no_torch_and_no_jax(module):
    out = subprocess.run(
        [sys.executable, "-c", _CHECK, module], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_package_export_is_lazy():
    """``tpu_faas_torch.resolve_device`` is still the package's export, and
    importing it is what loads torch."""
    code = ("import sys, tpu_faas_torch as t; assert 'torch' not in "
            "sys.modules; f = t.resolve_device; assert 'torch' in "
            "sys.modules; from tpu_faas_torch.device import resolve_device;"
            " assert f is resolve_device; print(f('cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "cpu", (
        out.stdout + out.stderr)


def test_stack_through_the_entry_points_on_the_cpu(tmp_path):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    legs = (
        ("tpu-push", ("--resident",), "push_worker", 1, 16, False),
        ("local", ("-w", "2"), None, 0, 8, False),
        ("pull", (), "pull_worker", 1, 8, False),
        ("push", ("--hb",), "push_worker", 2, 8, False),
    )
    out = chip_smoke.stack_run("cpu", str(tmp_path), legs=legs)
    assert [r["mode"] for r in out] == ["tpu-push", "local", "pull", "push"]
    assert [r["calls"] for r in out] == [16, 8, 8, 8]
    tp = out[0]
    # the resident tick on the CPU: its plain version, no kernel
    assert tp["tick_backend"] is None and tp["launches"] >= tp["ticks"] > 0
    # every child was reaped
    for name in os.listdir(tmp_path):
        assert name.endswith(".log"), name
