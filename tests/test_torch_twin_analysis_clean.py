"""Twins of tests/test_analysis_clean.py: the port's analysers over the
port's own package (``test_torch_host_copies.load_twins``, with the scanned
``PACKAGE`` pointed at ``tpu_faas_torch/``) report no finding of either
severity, and the CLI exits 0. The trace checker's scope case is JAX-only;
the port's scope test (every declared root of the card's path found) is in
tests/test_torch_analysis.py."""

from pathlib import Path

import tpu_faas_torch
from test_torch_host_copies import load_twins

PORT = Path(tpu_faas_torch.__file__).parent

globals().update(load_twins("test_analysis_clean.py", {
    "test_trace_scope_covers_the_scheduler_kernels": "JAX's kernel-module "
    "list under jax.jit (sched/pallas_kernels.py among them) and its "
    "_check_traced hook; the port's scope test holds the declared roots "
    "instead",
}, overrides={"PACKAGE": PORT}))


def test_twin_scans_the_port():
    assert PACKAGE == PORT
    assert run_paths.__module__ == "tpu_faas_torch.analysis.core"
