"""Every JAX test file is held against the port: a twin runs its source
against the port (``load_twins`` or ``dispatcher_twins`` in a
``tests/test_torch_*.py``), a named port test holds the same module
against JAX, or it is listed with the reason it has neither."""

import ast
import os

_TESTS = os.path.dirname(os.path.abspath(__file__))

#: JAX test files whose module a port test holds against JAX on identical
#: inputs (the Pallas kernels' interpret-mode tests among them), by file
COVERED_BY = {
    "test_sched_auction.py": "test_torch_auction.py",
    "test_sched_fused.py": "test_torch_resident.py",
    "test_sched_greedy.py": "test_torch_greedy.py",
    "test_sched_pallas.py": "test_torch_bid.py",
    "test_sched_resident.py": "test_torch_resident.py",
    "test_sched_sinkhorn.py": "test_torch_sinkhorn.py",
    "test_multihost.py": "test_torch_multihost.py",
    "test_multihost_resident.py": "test_torch_multihost.py",
}

#: JAX test files with no twin and no port test, each with its reason
NO_TWIN = {
    "test_bench.py": "bench/ has no counterpart: the port's benchmark is "
    "ROADMAP A.10, a new file, not a copy of the earlier harness",
}

#: the calls through which a twin file loads a JAX test file's source
_LOADERS = {"load_twins", "dispatcher_twins"}


def jax_test_files() -> set[str]:
    return {f for f in os.listdir(_TESTS)
            if f.startswith("test_") and f.endswith(".py")
            and not f.startswith("test_torch_")}


def twinned() -> dict[str, set[str]]:
    """Each JAX test file a twin loads, with the twin files that load it."""
    out: dict[str, set[str]] = {}
    for f in sorted(os.listdir(_TESTS)):
        if not (f.startswith("test_torch_") and f.endswith(".py")):
            continue
        with open(os.path.join(_TESTS, f), encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) in _LOADERS
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.setdefault(node.args[0].value, set()).add(f)
    return out


def test_every_jax_test_file_is_held():
    jax = jax_test_files()
    twins = twinned()
    held = set(twins) | set(COVERED_BY) | set(NO_TWIN)
    assert not jax - held, sorted(jax - held)
    # every entry names an existing JAX test file, so the lists cannot go
    # stale; a named port test exists; a reason is given
    assert set(twins) <= jax, sorted(set(twins) - jax)
    for name, port in COVERED_BY.items():
        assert name in jax, name
        assert os.path.isfile(os.path.join(_TESTS, port)), port
    for name, why in NO_TWIN.items():
        assert name in jax and why, name
    # a file is listed one way only
    assert not set(twins) & (set(COVERED_BY) | set(NO_TWIN))
    assert not set(COVERED_BY) & set(NO_TWIN)


def test_the_dispatcher_planes_have_twins():
    """The tpu-push dispatcher's opt-in planes and their neighbours each
    have a twin file of their own, ``test_torch_twin_<name>``."""
    planes = ("cancel", "express_lane", "payload_plane", "batch_plane",
              "data_plane_batching", "poison_guard", "priority", "timeout",
              "lease_config", "store_ha", "store_fuzz", "chaos_e2e",
              "overload_chaos", "shared_dispatchers", "property",
              "sim_fleet")
    twins = twinned()
    for name in planes:
        assert f"test_torch_twin_{name}.py" in twins.get(
            f"test_{name}.py", ()), name
