"""Drift guard for the host layers the port copies from the JAX package.

The port imports nothing of ``tpu_faas``, so every host module its entry
points reach (the import closure of the dispatcher, the gateway, the
workers, their supervisor and the client, the entry points included) has a
copy under ``tpu_faas_torch/`` at the same relative path. A copy equals
its original after one rename, ``tpu_faas`` to ``tpu_faas_torch`` in
import statements; a module changed on purpose is listed with its reason.
The JAX sources are read as text only.
"""

import ast
import gc
import os
import random
import re
import socket

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX = os.path.join(_REPO, "tpu_faas")
_PORT = os.path.join(_REPO, "tpu_faas_torch")

#: the import rename, the only edit a copy carries
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)tpu_faas(?=[.\s])", re.M)

#: modules copied as they stand (paths relative to each package)
COPIES = """
utils/__init__.py utils/logging.py utils/backoff.py utils/config.py
version.py
obs/attribution.py obs/metrics.py obs/expofmt.py obs/slo.py obs/trace.py
obs/tracectx.py obs/flightrec.py
core/serialize.py core/payload.py core/task.py core/columns.py
core/executor.py core/__init__.py
worker/messages.py worker/__init__.py worker/pool.py worker/drain.py
worker/pull_worker.py worker/push_worker.py
store/resp.py store/base.py store/memory.py store/snapshot.py
store/replication.py store/sharding.py store/server.py
store/launch.py store/native.py store/__init__.py store/racecheck.py
admission/signal.py admission/breaker.py admission/controller.py
admission/__init__.py
chaos/plan.py chaos/__init__.py
sched/estimator.py sched/health.py
graph/validate.py graph/__init__.py
dispatch/__init__.py dispatch/base.py dispatch/local.py dispatch/pull.py
dispatch/push.py
gateway/app.py gateway/__init__.py
client/sdk.py client/aio.py client/__init__.py
analysis/core.py analysis/locks.py analysis/obs.py analysis/eventloop.py
analysis/registries.py analysis/shardsafety.py analysis/metricsdiscipline.py
analysis/planegate.py
workloads.py compat/redis_shim/redis/__init__.py
bench/__init__.py
""".split()

#: copies changed on purpose, each with its reason
CHANGED = {
    "obs/profile.py": "the capture runs on torch.profiler (CUDA activity "
    "on the card) and opens with a warm-up on a card (ROADMAP C.6), its "
    "env vars drop 'JAX', and the jit cache cross-check has no "
    "counterpart; it also holds the resident scheduler's span recorder "
    "(record_function spans and a bounded in-memory log of spans and "
    "counters, on while any torch.profiler capture runs)",
    "obs/__init__.py": "its docstring names the torch.profiler capture and "
    "its env var",
    "worker/deploy.py": "the supervisor starts the port's workers "
    "(python -m tpu_faas_torch.worker.<protocol>_worker) where JAX's names "
    "its own, and its docstring's command line names the port",
    "gateway/__main__.py": "main() runs under an if __name__ == "
    "'__main__' guard, so importing every module of the port (the package "
    "test, chip_smoke.py's host phase) starts no gateway",
    "graph/frontier.py": "the device ops are torch ops; the host part "
    "(pad_pref, pad_edges, GraphFrontier) is checked statement for "
    "statement below",
    "dispatch/tpu_push.py": "a device argument (default 'cuda', resolved "
    "before the store and socket, so no card means no dispatcher) passed "
    "to the scheduler and to the multihost tick or resident scheduler; "
    "tick_backend accepted and not passed on (B1 serves every "
    "resident tick on CUDA), so the status blocks report the port "
    "scheduler's own: 'fused_cuda' for the resident tick on the card, "
    "None on the CPU and for the batch tick; the kernels are built "
    "in the constructor on CUDA (B1 when resident, B2 under the batch "
    "auction), so no nvcc run stalls the first tick; the batch tick's "
    "outputs are read with to_host (a CUDA tensor has no numpy view); "
    "the profiler's shape signature names the device type where JAX "
    "wrote the backend label 'xla'; comments and the module docstring "
    "name the port; the act loops (_tick_inner, _act_on_resolved) stamp "
    "a task's 'sent' before its frame goes out and pass the stamp to "
    "traces.note after the send, where JAX's note after it, so a worker's "
    "exec_start never precedes 'sent' (ROADMAP C.8). Only __init__, "
    "_tick_inner, _tick_resident and _act_on_resolved differ, checked "
    "below",
    "dispatch/__main__.py": "local, pull and push start as JAX's do "
    "(they touch no device); tpu-push gains --device cuda|cpu and "
    "--dist-backend nccl|gloo; --multihost joins a "
    "torch.distributed group (its timeout from --follower-watchdog; "
    "--device cpu gives the process one CPU position); the XLA compile "
    "cache and the jax_platforms pin dropped; --tick-backend accepted "
    "and unused; a multihost lead and its followers leave the group "
    "before they exit (distributed.shutdown, ROADMAP C.7). Only main "
    "differs, checked below",
    "store/client.py": "the subscription's socket sets an 8 MiB "
    "SO_RCVBUF (SUBSCRIBER_RCVBUF) before it connects, so _Conn connects "
    "through its own getaddrinfo loop (ROADMAP C.5: on a gVisor-style "
    "network stack a burst of more than ~1,500 unread announces stalled "
    "the bus for seconds with the default window). Only the constant, "
    "_Conn.__init__ and _RespSubscription._connect differ, checked below",
    "parallel/__init__.py": "the port's package: exports the torch "
    "mesh's names",
    "parallel/distributed.py": "the process group on torch.distributed "
    "(tcp:// or env://, NCCL or gloo) in place of jax.distributed",
    "parallel/mesh.py": "a mesh is a list of (rank, device) positions; "
    "the shard_map bodies are loops over a process's positions with "
    "psum/pmax/ppermute/all_gather on lists and torch.distributed; the "
    "GSPMD paths are all_gather plus the single-device function",
    "parallel/multihost_tick.py": "dist.broadcast of the packed buffer "
    "for broadcast_one_to_all; the assignment comes back whole from the "
    "sharded functions' all_gather",
    "parallel/multihost_resident.py": "every process holds a full replica "
    "of the resident state and runs B1 on it, where JAX shards the task "
    "leaves under GSPMD; dist.barrier for sync_global_devices",
    "sched/problem.py": "PlacementProblem holds torch tensors on an "
    "explicit device (build(..., device='cuda'), uploaded with "
    "device.upload); pad_to and check_assignment as in JAX",
    "analysis/__init__.py": "its docstring describes the port's checkers "
    "(the three rewritten ones among them)",
    "analysis/__main__.py": "the CLI is python -m tpu_faas_torch.analysis: "
    "it scans the port's package by default and names itself so",
    "analysis/protocol.py": "the store-package exemption keys on a "
    "tpu_faas_torch/store path (and the installed tpu_faas_torch.store), "
    "where JAX's keys on tpu_faas/store",
    "analysis/tracesafety.py": "rewritten for torch: the scope is every "
    "function reachable from the card's declared device entry points "
    "(ROOTS), not jax.jit; host-sync, data-dependent-branch and print "
    "kept, host-time, python-random, state-mutation and "
    "unknown-axis-name dropped (its docstring says why)",
    "analysis/kernelparity.py": "rewritten for the CUDA kernels' ctypes "
    "bindings: launch lists, argtypes and pointer types against the "
    "extern \"C\" signatures read from the .cu sources, where JAX's reads "
    "the Pallas in_specs and aliases",
    "analysis/devicesnapshot.py": "rewritten for torch uploads: "
    "torch.from_numpy(a) copied with non_blocking=True, where JAX's checks "
    "jnp.asarray and jax.device_put",
    "bench/timing.py": "the readback is a host copy of the first tensor "
    "leaf (a numpy leaf passes through), where JAX's reads the first "
    "jax.tree_util leaf; the transport floor is one small torch op on a "
    "device (default 'cuda') and its .item(), where JAX's jits one",
    "bench/harness.py": "the bench's device (DEVICE_ENV, bench_device: the "
    "CLI's --device, inherited by the bench's children); the workers are "
    "the port's, each in a session of its own whose group is killed at "
    "teardown (JAX's kills the worker alone and leaves its pool's "
    "forkserver and resource tracker behind); the tpu-push mode builds the "
    "port's dispatcher on full_stack's and measure_service's device; each "
    "run registers its function anew (JAX's second run gets a 404). Only "
    "the functions BENCH_CHANGED names differ, checked below",
    "bench/__main__.py": "--device cuda|cpu (cuda without a GPU is "
    "refused); every line says where it ran (the card's name and power "
    "limit from nvidia-smi, or cpu) and, on the card, B1's and B2's "
    "launches; a measurement that raises or records a *_error field still "
    "prints one JSON line and the CLI exits non-zero",
    "bench/configs.py": "the device configs run on the bench's device "
    "through the port's solvers and kernels, the host configs build the "
    "port's dispatcher there and start the port's processes. Only the "
    "functions BENCH_CHANGED names differ, checked below",
    "bench/fleet_child.py": "the XLA compile cache dropped (the port "
    "builds its CUDA libraries once, into tpu_faas_torch/csrc/build/); "
    "the dispatcher on the bench's device. Only main differs, checked below",
    "bench/batch_leg_child.py": "the XLA compile cache dropped; the "
    "dispatcher on the bench's device. Only main differs, checked below",
}

#: closure modules the port does not copy: ported under its own name by an
#: earlier slice, or not needed, each with its reason
NOT_COPIED = {
    "tpu_faas": "the port's package docstring and exports are its own",
    "tpu_faas.sched": "the port's scheduler package is its own",
    "tpu_faas.sched.state": "ported: sched/state.py",
    "tpu_faas.sched.greedy": "ported: sched/greedy.py",
    "tpu_faas.sched.auction": "ported: sched/auction.py",
    "tpu_faas.sched.sinkhorn": "ported: sched/sinkhorn.py",
    "tpu_faas.sched.resident": "ported: sched/resident.py",
    "tpu_faas.sched.pallas_fused": "ported as the CUDA kernel B1: "
    "sched/fused_tick.py, csrc/fused_tick.cu",
    "tpu_faas.sched.pallas_kernels": "ported as the CUDA kernel B2: "
    "sched/bid.py, csrc/bid_top2.cu",
    "tpu_faas.spec": "ported: spec/",
    "tpu_faas.spec.policy": "ported: spec/policy.py",
    "tpu_faas.spec.straggler": "ported: spec/straggler.py",
    "tpu_faas.tenancy": "ported: tenancy/",
    "tpu_faas.tenancy.config": "ported: tenancy/config.py",
    "tpu_faas.tenancy.fairshare": "ported: tenancy/fairshare.py",
    "tpu_faas.sched.oracle": "ported: sched/oracle.py",
    "tpu_faas.sim": "ported: sim/",
    "tpu_faas.sim.fleet": "ported: sim/fleet.py",
}

#: modules no entry point imports that the port keeps all the same: the
#: tests' and the benchmark's task functions, and redis-py's surface for
#: the reference's own processes
BESIDE_THE_CLOSURE = ("workloads.py", "compat/redis_shim/redis/__init__.py")

#: the JAX modules with no counterpart in the port, each with its reason
NO_COUNTERPART = {
    "sched/pallas_fused.py": "kernel B1, ported as CUDA: sched/fused_tick.py "
    "and csrc/fused_tick.cu",
    "sched/pallas_kernels.py": "kernel B2, ported as CUDA: sched/bid.py and "
    "csrc/bid_top2.cu",
}


def renamed(src: str) -> str:
    """A JAX module's source as its copy must read."""
    return _IMPORT.sub(r"\1tpu_faas_torch", src)


def _read(*parts: str) -> str:
    with open(os.path.join(*parts), encoding="utf-8") as fh:
        return fh.read()


def _module_file(root: str, mod: str) -> str | None:
    p = os.path.join(root, *mod.split(".")[1:])
    for cand in (os.path.join(p, "__init__.py"), p + ".py"):
        if os.path.exists(cand):
            return cand
    return None


def _imports(mod: str) -> set[str]:
    """Every ``tpu_faas`` module a JAX module imports, at module level or
    inside a function, with the packages on the way."""
    path = _module_file(_JAX, mod)
    pkg = mod if path.endswith("__init__.py") else mod.rsplit(".", 1)[0]
    found = set()
    for node in ast.walk(ast.parse(_read(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            if name.split(".")[0] != "tpu_faas":
                continue
            parts = name.split(".")
            for i in range(1, len(parts) + 1):
                sub = ".".join(parts[:i])
                if _module_file(_JAX, sub):
                    found.add(sub)
    return found


#: the modules a user runs or imports: every dispatcher mode, the gateway,
#: the store server, the workers and their supervisor, the client, the
#: analysers and the bench (its CLI and the two children it starts)
ENTRY_POINTS = (
    "tpu_faas.dispatch.tpu_push", "tpu_faas.dispatch.__main__",
    "tpu_faas.gateway", "tpu_faas.gateway.__main__", "tpu_faas.store.server",
    "tpu_faas.worker.push_worker", "tpu_faas.worker.pull_worker",
    "tpu_faas.worker.deploy", "tpu_faas.client", "tpu_faas.client.aio",
    "tpu_faas.analysis.__main__", "tpu_faas.bench.__main__",
    "tpu_faas.bench.fleet_child", "tpu_faas.bench.batch_leg_child",
)


def dispatcher_closure() -> set[str]:
    """The import closure of the port's entry points (:data:`ENTRY_POINTS`),
    the entry points included."""
    todo = list(ENTRY_POINTS)
    seen: set[str] = set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        todo.extend(_imports(mod) - seen)
    return seen


def _rel(mod: str) -> str:
    return os.path.relpath(_module_file(_JAX, mod), _JAX)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original(rel):
    want = renamed(_read(_JAX, rel))
    got = _read(_PORT, rel)
    assert got == want, f"tpu_faas_torch/{rel} drifted from tpu_faas/{rel}"


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_copies_differ_on_purpose(rel):
    """A listed module exists in the port, is not a plain copy (else it
    belongs in COPIES), and imports nothing of the JAX package."""
    got = _read(_PORT, rel)
    assert got != renamed(_read(_JAX, rel))
    assert not re.search(r"^\s*(from|import)\s+(jax|tpu_faas)\b(?!_torch)",
                         got, re.M)


def test_every_closure_module_is_copied_or_accounted_for():
    closure = dispatcher_closure()
    assert len(closure) >= 60, sorted(closure)
    listed = set(COPIES) | set(CHANGED)
    for mod in sorted(closure):
        if mod in NOT_COPIED:
            continue
        rel = _rel(mod)
        assert rel in listed, f"{mod} is neither copied nor accounted for"
        assert os.path.exists(os.path.join(_PORT, rel)), rel
    # nothing listed that the closure does not reach, but the parser the
    # metrics tests share, the race monitor the dispatcher's e2e twins wrap
    # its stores in, and the modules kept beside the closure
    reached = {_rel(m) for m in closure} | {
        "obs/expofmt.py", "store/racecheck.py", *BESIDE_THE_CLOSURE}
    assert listed <= reached, sorted(listed - reached)
    # every entry names a module the closure reaches
    outside = set(NOT_COPIED) - closure
    assert not outside, sorted(outside)


def test_every_jax_module_has_a_counterpart():
    """Every ``.py`` under ``tpu_faas/`` has a file at the same relative
    path in the port, but for :data:`NO_COUNTERPART`; and each exception
    still names a module of the JAX package that the port lacks."""
    missing = set()
    for d, _dirs, files in os.walk(_JAX):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), _JAX)
                if not os.path.exists(os.path.join(_PORT, rel)):
                    missing.add(rel.replace(os.sep, "/"))
    excused = {m for m in missing
               if any(m == k or (k.endswith("/") and m.startswith(k))
                      for k in NO_COUNTERPART)}
    assert missing == excused, sorted(missing - excused)
    for k in NO_COUNTERPART:
        assert any(m == k or m.startswith(k) for m in missing), k


def _defs(src: str) -> dict[str, str]:
    """Every function and method of a module by qualified name, and every
    other top-level statement but the imports and the docstring, as
    ``ast.dump`` (comments do not count)."""
    out: dict[str, str] = {}

    def walk(body, prefix):
        rest = [n for n in body
                if not isinstance(n, (ast.Import, ast.ImportFrom))]
        for i, n in enumerate(rest):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[prefix + n.name] = ast.dump(n)
            elif isinstance(n, ast.ClassDef):
                walk(n.body, f"{prefix}{n.name}.")
            elif not (i == 0 and isinstance(n, ast.Expr)):
                out[f"{prefix}<statement {i}>"] = ast.dump(n)

    walk(ast.parse(src).body, "")
    return out


#: the only functions a changed dispatcher or store module may change
#: (CHANGED says why)
DISPATCH_CHANGED = {
    "dispatch/tpu_push.py": {"TpuPushDispatcher.__init__",
                             "TpuPushDispatcher._tick_inner",
                             "TpuPushDispatcher._tick_resident",
                             "TpuPushDispatcher._act_on_resolved"},
    "dispatch/__main__.py": {"main"},
    # <statement 5>: the new constant SUBSCRIBER_RCVBUF
    "store/client.py": {"<statement 5>", "_Conn.__init__",
                        "_RespSubscription._connect"},
}


#: the only functions (and module statements) the bench's changed modules
#: may change, each with its reason; every other function of theirs stays
#: its JAX original after the import rename
BENCH_CHANGED = {
    "bench/harness.py": {
        "<statement 3>": "DEVICE_ENV, the variable the bench's device "
        "rides to its children",
        "bench_device": "the bench's device, 'cuda' unless the CLI asked "
        "for the CPU",
        "_spawn_worker": "starts the port's worker, in a session of its own",
        "full_stack": "tpu-push on the device argument; each worker's "
        "process group killed at teardown",
        "measure_service": "passes its device argument to full_stack",
        "_measure_once": "registers the function by a POST each run: "
        "JAX's client.register answers from the SDK's memo, and after the "
        "store's flush between runs that id is gone (a 404 on the second "
        "run, ROADMAP C, behaviours of the JAX reference)",
    },
    "bench/fleet_child.py": {"main": "no XLA compile cache; the dispatcher "
                             "on the bench's device"},
    "bench/batch_leg_child.py": {"main": "no XLA compile cache; the "
                                 "dispatcher on the bench's device"},
    "bench/configs.py": {
        **{name: "builds the port's TpuPushDispatcher on the bench's device"
           for name in ("config_9_host_dispatch", "config_10_overload",
                        "config_11_payload_plane", "_latency_leg",
                        "config_13_graph_pipeline", "_fleet_chaos_leg",
                        "_tenant_stack", "_tail_stack", "_composed_stack",
                        "_chaos_stack", "_graph_locality_leg")},
        **{name: "starts the port's module (python -m tpu_faas_torch....)"
           for name in ("_spawn_store_server", "config_14_fleet",
                        "config_17_batched_plane", "_tail_spawn_worker",
                        "_chaos_spawn_worker")},
        "config_3_auction_1k_10k": "problems on the device; the port's "
        "auction_placement_impl and rank_match_placement; to_host reads",
        "config_4_sinkhorn_hetero": "problems on the device; the port's "
        "sinkhorn_placement_bucketed_impl; to_host reads",
        "config_5_churn_4k": "SimFleet and the transport floor on the "
        "device",
        "config_7_bid_headline": "the plain bid_top2_stream_impl and the "
        "CUDA bid_top2 (plain_ms_per_round, cuda_ms_per_round) where JAX "
        "times XLA and Pallas; no auto backend (its TPU cell budget does "
        "not carry over); the kernel leg skipped on the CPU",
        "config_8_estimation": "rank_match_placement on the device, read "
        "back with to_host",
        "_tick_leg": "a 'fused' leg (the scheduler as the dispatcher runs "
        "it, B1 on the card) and a 'plain' one (_plain_tick_scheduler) on "
        "the bench's device, where JAX passes tick_backend",
        "config_15_tick_trajectory": "its legs named plain and fused; the "
        "device in place of the JAX backend",
        "_tick_multichip_leg": "the port's mesh over CUDA devices (skipped "
        "below two, on the CPU too)",
        "_plain_tick_scheduler": "new: the plain tick as a scheduler, "
        "config 15's plain leg",
    },
}


@pytest.mark.parametrize("rel", sorted(DISPATCH_CHANGED))
def test_dispatcher_changes_only_the_listed_functions(rel):
    want = _defs(renamed(_read(_JAX, rel)))
    got = _defs(_read(_PORT, rel))
    differ = {k for k in want.keys() | got.keys() if want.get(k) != got.get(k)}
    assert differ == DISPATCH_CHANGED[rel]


@pytest.mark.parametrize("rel", sorted(BENCH_CHANGED))
def test_bench_changes_only_the_listed_functions(rel):
    want = _defs(renamed(_read(_JAX, rel)))
    got = _defs(_read(_PORT, rel))
    differ = {k for k in want.keys() | got.keys() if want.get(k) != got.get(k)}
    assert differ == set(BENCH_CHANGED[rel])
    assert all(BENCH_CHANGED[rel].values())


def test_frontier_host_part_is_a_copy():
    """graph/frontier.py: the host bookkeeping is the JAX module's,
    statement for statement."""
    def defs(src):
        return {n.name: ast.dump(n) for n in ast.parse(src).body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}

    want = defs(_read(_JAX, "graph", "frontier.py"))
    got = defs(_read(_PORT, "graph", "frontier.py"))
    for name in ("pad_pref", "pad_edges", "GraphFrontier"):
        assert got[name] == want[name], name


# ---------------------------------------------------------------------------
# the twins of the JAX unit tests (tests/test_torch_twin_*.py) load through
# this: a JAX test module's source with its imports of modules the port has
# renamed, so the same tests run against the copies
# ---------------------------------------------------------------------------
_TEST_IMPORT = re.compile(
    r"^(\s*(?:from|import)\s+)tpu_faas((?:\.\w+)*)(?=(\s+import\s+(\w+))?)",
    re.M,
)


def _port_has(mod: str) -> bool:
    return _module_file(_PORT, "tpu_faas_torch" + mod) is not None


def twin_source(src: str, keep: tuple[str, ...] = (),
                processes: tuple[str, ...] = (),
                twins: tuple[str, ...] = (),
                edits: dict[str, str] | None = None) -> str:
    """A JAX test module's source with every import of a module the port
    has pointed at the port (``from tpu_faas import chaos`` included);
    imports of modules the port lacks, and of the modules in ``keep``,
    stay as they are. ``processes`` names module prefixes a test starts
    as a process from a string (``"tpu_faas.worker."`` in
    ``f"tpu_faas.worker.{kind}"``): a string literal that begins with one
    is pointed at the port's package too. ``twins`` names JAX test modules
    a test imports helpers from (``from tests.test_workers_e2e import
    _spawn_worker``, at the top or inside a body): those imports read the
    module's twin, ``test_torch_twin_<name>``, instead. ``edits`` are
    literal replacements, each of which must occur in the source (an
    array library swapped inside a test's body, say)."""
    def sub(m):
        mod = m.group(2) or (f".{m.group(4)}" if m.group(4) else "")
        if mod and _port_has(mod) and "tpu_faas" + mod not in keep:
            return f"{m.group(1)}tpu_faas_torch{m.group(2)}"
        return m.group(0)

    src = _TEST_IMPORT.sub(sub, src)
    for prefix in processes:
        assert prefix.startswith("tpu_faas.") and _port_has(
            "." + prefix.strip(".").split(".", 1)[1]), prefix
        src = re.sub(r"""(?<=["'])""" + re.escape(prefix),
                     "tpu_faas_torch" + prefix[len("tpu_faas"):], src)
    for name in twins:
        twin = "test_torch_twin_" + name[len("test_"):]
        assert os.path.exists(os.path.join(_REPO, "tests", twin + ".py")), twin
        src, n = re.subn(rf"^(\s*from\s+)tests\.{name}(?=\s+import\s)",
                         rf"\g<1>{twin}", src, flags=re.M)
        assert n, name
    for old, new in (edits or {}).items():
        assert old in src, old
        src = src.replace(old, new)
    return src


def load_twins(test_file: str, exclude: dict[str, str],
               keep: tuple[str, ...] = (), overrides: dict | None = None,
               processes: tuple[str, ...] = (), twins: tuple[str, ...] = (),
               edits: dict[str, str] | None = None) -> dict:
    """Run ``tests/<test_file>``'s source, with :func:`twin_source`'s
    renames, as a module namespace, and return its tests, fixtures and
    helpers minus ``exclude`` (each name with its reason: a test that
    starts a gateway, a dispatcher, a worker or a process, or sleeps for
    seconds). Every excluded name must exist, so the list cannot go
    stale. ``keep`` names JAX modules a twin still reads from the
    reference (the placement a host-layer test feeds, say);
    ``overrides`` replaces module-level names in the namespace (the
    port's entry points on the CPU); ``processes``, ``twins`` and
    ``edits`` as in :func:`twin_source`, so a twin starts the port's
    processes and reads the port's helpers."""
    path = os.path.join(_REPO, "tests", test_file)
    ns = {"__name__": "twin_" + test_file[:-3], "__file__": path}
    src = twin_source(_read(path), keep, processes, twins, edits)
    assert src != _read(path), f"{test_file} imports nothing the port has"
    exec(compile(src, path, "exec"), ns)
    missing = sorted(set(exclude) - set(ns))
    assert not missing, missing
    ns.update(overrides or {})
    return {k: v for k, v in ns.items()
            if k not in exclude and not k.startswith("__")}


def only_params(fn, argname: str, values: list):
    """A twin of a parametrized test, run over ``values`` alone (the
    in-process cases of a test that also starts a native store process)."""
    import types

    twin = types.FunctionType(fn.__code__, fn.__globals__, fn.__name__,
                              fn.__defaults__, fn.__closure__)
    twin.__dict__.update(fn.__dict__)
    twin.pytestmark = [
        m for m in getattr(fn, "pytestmark", [])
        if not (m.name == "parametrize" and m.args[0] == argname)
    ]
    return pytest.mark.parametrize(argname, values)(twin)


# ---------------------------------------------------------------------------
# the dispatcher's twins: the port's TpuPushDispatcher on the CPU wherever a
# JAX test builds it, through a module-level name or an import inside a
# test's body
# ---------------------------------------------------------------------------
def cpu_dispatcher():
    """The port's dispatcher class with ``device="cpu"`` bound."""
    from functools import partial

    from tpu_faas_torch.dispatch import tpu_push

    return partial(tpu_push.TpuPushDispatcher, device="cpu")


@pytest.fixture
def dispatcher_on_cpu(monkeypatch):
    """Imports of ``tpu_faas_torch.dispatch.tpu_push.TpuPushDispatcher``
    inside a twin's body get :func:`cpu_dispatcher` for the test, and
    torch runs one intra-op thread until it ends. The dispatcher's tick
    shares the test's process with its gateway, store and client threads,
    as the JAX case's does; its small host ops (the liveness pass runs
    over the whole in-flight table) each opened a parallel region of
    torch's pool, and on a loaded host gathering the pool's threads took
    tens of milliseconds a tick where JAX's one compiled call took a few
    (ROADMAP C.12)."""
    import torch

    from tpu_faas_torch.dispatch import tpu_push

    monkeypatch.setattr(tpu_push, "TpuPushDispatcher", cpu_dispatcher())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def frozen_heap():
    """Every object the process holds before the test moved out of the
    collector's reach until it ends (``gc.freeze``), so a full collection
    during a test that times one request scans the test's own objects, not
    all that earlier test files left in this worker: at the 380-500k
    objects a worker of the suite holds, one pass took 160-290 ms
    (ROADMAP C.9)."""
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def check_ports_dispatcher(d) -> None:
    """Assert that ``d`` is the port's dispatcher on the CPU, then close
    its socket."""
    try:
        assert (type(d).__module__, type(d).__qualname__) == (
            "tpu_faas_torch.dispatch.tpu_push", "TpuPushDispatcher")
        assert d.arrays.device.type == "cpu"
    finally:
        d.stop()
        d.socket.close(linger=0)


def dispatcher_twins(test_file: str, cases: list[str], factory: tuple,
                     keep: tuple[str, ...] = ()) -> dict:
    """The dispatcher cases ``cases`` of ``tests/<test_file>`` as twins,
    with every helper and fixture of the file, and the fixture
    :func:`dispatcher_on_cpu` on each (the file's other tests are held
    against JAX elsewhere; ``keep`` as in :func:`load_twins`, for the
    scheduler names only those tests read). ``factory`` is the file's own
    dispatcher factory and its arguments: one more test,
    ``test_twin_builds_the_ports_dispatcher``, checks what it builds."""
    ns = load_twins(test_file, {}, keep,
                    overrides={"TpuPushDispatcher": cpu_dispatcher()})
    missing = sorted(set(cases) - set(ns))
    assert not missing, missing
    out = {k: v for k, v in ns.items()
           if not k.startswith("test") or k in cases}
    on_cpu = pytest.mark.usefixtures("dispatcher_on_cpu")
    for name in cases:
        out[name] = on_cpu(out[name])

    @on_cpu
    def test_twin_builds_the_ports_dispatcher():
        name, *args = factory
        check_ports_dispatcher(ns[name](*args))

    out["test_twin_builds_the_ports_dispatcher"] = (
        test_twin_builds_the_ports_dispatcher)
    out["dispatcher_on_cpu"] = dispatcher_on_cpu
    return out


# ---------------------------------------------------------------------------
# ports for servers a child process binds later (a rendezvous store, a
# dispatcher's socket)
# ---------------------------------------------------------------------------
def _ephemeral_low() -> int:
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            return int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def reserved_port() -> int:
    """A free TCP port below the kernel's ephemeral range.

    A port from ``bind(0)`` lies in that range and, once its probe socket
    closes, the kernel may hand it to the next process that binds port 0
    or connects out; under the suite's parallel workers (gateways, stores,
    dispatchers) a child then failed to bind it (EADDRINUSE). A port below
    the range is taken only by a process that asks for it by number, so it
    stays free between this probe and the child's bind."""
    rng = random.SystemRandom()
    hi = _ephemeral_low()
    for _ in range(200):
        port = rng.randrange(max(1024, hi - 12000), hi)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port below the ephemeral range")
