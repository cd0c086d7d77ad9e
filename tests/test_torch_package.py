"""Rules of the PyTorch port as a package: it never loads JAX or the JAX
package, and its entry points run on the card unless asked for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import tpu_faas_torch
names = [m.name for m in pkgutil.walk_packages(tpu_faas_torch.__path__,
                                               "tpu_faas_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "tpu_faas" or m.startswith("tpu_faas."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 64, names
for pkg in ("graph", "store", "obs", "core", "admission", "dispatch",
            "dispatch.tpu_push", "dispatch.base", "store.racecheck"):
    assert "tpu_faas_torch." + pkg in names, pkg
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=_REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": _REPO},
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_gpu(no_gpu):
    from tpu_faas_torch.sched.resident import ResidentScheduler
    from tpu_faas_torch.sched.state import SchedulerArrays
    from tpu_faas_torch.sim import SimFleet

    rng = np.random.default_rng(0)
    for make in (
        lambda **kw: SchedulerArrays(max_workers=4, **kw),
        lambda **kw: ResidentScheduler(max_workers=4, max_pending=8, **kw),
        lambda **kw: SimFleet(n_workers=2, max_pending=8, rng=rng, **kw),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device="cuda")
        assert make(device="cpu") is not None


def test_library_name_follows_the_source():
    from tpu_faas_torch import build

    path = build.library_path("fused_tick")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libfused_tick-") and path.suffix == ".so"
    assert build.library_path("fused_tick") == path
