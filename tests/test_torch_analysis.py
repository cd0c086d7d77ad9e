"""The port's own analysers (``tpu_faas_torch/analysis``): a fixture that
fires and one that does not for every rule of the three rewritten checkers
(trace, kernelparity, devicesnapshot), the bindings of the real CUDA
wrappers broken three ways in a scratch copy, the trace checker's scope,
the port's forms of the JAX cases that key on paths, and the CLI in a fresh
interpreter. ``sched/problem.py`` is held to JAX's ``PlacementProblem``
here too. Every snippet runs through the real ``run_paths``."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import tpu_faas_torch
from tpu_faas_torch.analysis import (
    DeviceSnapshotChecker,
    KernelParityChecker,
    TraceSafetyChecker,
    run_paths,
)
from tpu_faas_torch.analysis.__main__ import main as analysis_main
from tpu_faas_torch.analysis.core import Module
from tpu_faas_torch.analysis.tracesafety import ROOTS

PORT = Path(tpu_faas_torch.__file__).parent
REPO = PORT.parent


def write(root: Path, rel: str, src: str) -> Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def hits(findings, prefix: str = ""):
    """(rule, line) pairs of the findings whose rule starts with prefix."""
    return [(f.rule, f.line) for f in findings if f.rule.startswith(prefix)]


def only(tmp_path: Path, checker) -> list:
    return run_paths([tmp_path], checker_classes=[checker])


# -- trace: host syncs on the card's path ------------------------------------

#: one root of the card's path, as a fixture module names it
_BID = "sched/bid.py"

HOST_SYNC_FORMS = {
    "item": "return x.sum().item()",
    "tolist": "return x.tolist()",
    "cpu": "return x.cpu()",
    "numpy": "return x.numpy()",
    "int": "return int(x.sum())",
    "float": "return float(x[0])",
    "bool": "return bool(x.any())",
    "tensor_on_device": "return torch.tensor(1.0, device=x.device)",
    "as_tensor_on_device": "return torch.as_tensor(n, device=x.device)",
    "nonzero_method": "return x.nonzero()",
    "torch_nonzero": "return torch.nonzero(x)",
    "masked_select": "return torch.masked_select(x, x > 0)",
    "where_one_arg": "return torch.where(x > 0)",
    "synchronize": "torch.cuda.synchronize()",
    "stream_synchronize": "torch.cuda.current_stream().synchronize()",
    "to_host": "return to_host(x)",
}


@pytest.mark.parametrize("form", sorted(HOST_SYNC_FORMS))
def test_trace_host_sync_fires_at_a_root(tmp_path, form):
    write(tmp_path, _BID, f"""\
        import torch
        from tpu_faas_torch.device import to_host


        def bid_top2(x: torch.Tensor, n: float = 1.0):
            {HOST_SYNC_FORMS[form]}
        """)
    assert hits(only(tmp_path, TraceSafetyChecker)) == [("trace.host-sync", 6)]


def test_trace_host_sync_clean_forms(tmp_path):
    """Shape probes, host arrays, a blocking host copy, device scalars made
    on the device and ops of a fixed output size are no syncs."""
    write(tmp_path, _BID, """\
        import numpy as np
        import torch


        def bid_top2(x: torch.Tensor, host: np.ndarray, n: int):
            k = int(x.shape[0]) + len(x) + x.numel() + int(n)
            m = int(host.sum()) + float(np.float32(2.0))
            y = torch.where(x > 0, x, 0.0).clamp_min(1e-6)
            t = torch.from_numpy(host).to(x.device)
            z = torch.tensor(1.0, device="cpu")
            return y, t, z, k, m, host.tolist(), x.device.type == "cuda"
        """)
    assert only(tmp_path, TraceSafetyChecker) == []


def test_trace_data_dependent_branch_fires_and_static_tests_are_clean(
        tmp_path):
    write(tmp_path, _BID, """\
        import torch


        def bid_top2(x: torch.Tensor, flag=None):
            if x.any():
                x = x + 1
            while (x > 0).all():
                x = x - 1
            y = x if x.sum() else -x
            if flag is None and x.shape[0] > 2 and isinstance(x, torch.Tensor):
                y = y * 2
            if x.device.type == "cuda":
                y = y + 1
            return y
        """)
    assert hits(only(tmp_path, TraceSafetyChecker)) == [
        ("trace.data-dependent-branch", 5),
        ("trace.data-dependent-branch", 7),
        ("trace.data-dependent-branch", 9),
    ]


def test_trace_print_warns_on_the_path_only(tmp_path):
    write(tmp_path, _BID, """\
        import torch


        def bid_top2(x: torch.Tensor):
            print("bidding")
            return x


        def report(x):
            print(x)
        """)
    found = only(tmp_path, TraceSafetyChecker)
    assert hits(found) == [("trace.print", 5)]
    assert found[0].severity == "warning"


def test_trace_scope_is_reachability_from_the_roots(tmp_path):
    """Off the declared roots nothing is judged; a helper the root names is
    (across modules, through a closure, through ``self``), and a tensor
    passed to a helper's unannotated parameter is a tensor there."""
    write(tmp_path, "sched/helpers.py", """\
        def count(mask):
            return int(mask.sum())


        def unreached(x):
            return x.item()
        """)
    write(tmp_path, _BID, """\
        import torch

        from sched.helpers import count


        class Kernel:
            def __call__(self, x: torch.Tensor):
                return self._rounds(x)

            def _rounds(self, x):
                def left():
                    return bool((x > 0).any())

                while left():
                    x = x - count(x > 0)
                return x


        KERNEL = Kernel()


        def bid_top2(x: torch.Tensor):
            return KERNEL(x)


        def not_on_the_path(x: torch.Tensor):
            return x.item()
        """)
    assert [(Path(f.path).name, f.rule, f.line)
            for f in only(tmp_path, TraceSafetyChecker)] == [
        ("bid.py", "trace.host-sync", 12),
        ("helpers.py", "trace.host-sync", 2),
    ]


def test_trace_suppression_is_the_inventory(tmp_path):
    write(tmp_path, _BID, """\
        import torch


        def bid_top2(x: torch.Tensor):
            n = int(x.sum())  # faas: allow(trace.host-sync) the bidder count
            return x.tolist()  # faas: allow(trace.print) wrong rule
        """)
    found = only(tmp_path, TraceSafetyChecker)
    assert hits(found) == [("core.stale-suppression", 6),
                           ("trace.host-sync", 6)]


def test_trace_scope_sees_every_declared_root():
    """The port's package: every root of ROOTS is found, the kernel
    wrappers' plain versions and the solvers are in scope, and the gate's
    clean result is not vacuous (the suppressed syncs were found)."""
    checker = TraceSafetyChecker()
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).as_posix()
        list(checker.check(Module.parse(path, rel, path.read_text())))
    found = list(checker.finalize())
    assert checker.found_roots == set(ROOTS)
    for name in (
        "tpu_faas_torch.sched.state:packed_tick",
        "tpu_faas_torch.sched.state:scheduler_tick_impl",
        "tpu_faas_torch.sched.state:SchedulerArrays.tick",
        "tpu_faas_torch.sched.greedy:rank_match_placement_impl",
        "tpu_faas_torch.sched.auction:auction_placement_impl",
        "tpu_faas_torch.sched.sinkhorn:sinkhorn_placement_impl",
        "tpu_faas_torch.sched.resident:ResidentScheduler._launch",
        "tpu_faas_torch.sched.resident:ResidentScheduler.resolve_next",
        "tpu_faas_torch.sched.resident:_resident_tick_impl",
        "tpu_faas_torch.sched.fused_tick:fused_resident_tick",
        "tpu_faas_torch.sched.fused_tick:FusedTickKernel.auction",
        "tpu_faas_torch.sched.bid:bid_top2",
        "tpu_faas_torch.sched.bid:bid_top2_stream_impl",
        "tpu_faas_torch.parallel.mesh:sharded_scheduler_tick",
        "tpu_faas_torch.parallel.mesh:psum",
        "tpu_faas_torch.device:to_host",
    ):
        assert name in checker.traced, name
    assert len(checker.traced) >= 60
    # unsuppressed, the scan reports the inventory's sites
    assert len([f for f in found if f.rule == "trace.host-sync"]) >= 25
    # the probe-build readers are diagnostics, not the card's path
    assert ("tpu_faas_torch.sched.fused_tick:FusedTickKernel.rank_split"
            not in checker.traced)


def test_every_host_sync_suppression_carries_its_reason():
    """Each ``trace`` suppression in the port names what it reads back, on
    its own line."""
    n = 0
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        mod = Module.parse(path, path.name, text)
        lines = text.splitlines()
        for line, tokens in mod.allows.items():
            if not any(t == "*" or t.startswith("trace") for t in tokens):
                continue
            n += 1
            why = lines[line - 1].split("faas: allow(", 1)[1].split(")", 1)[1]
            assert len(why.strip()) >= 10, (path, line)
    assert n >= 25


# -- kernelparity: the ctypes bindings ---------------------------------------

_CU = """\
    #define LANE_PARAMS int32_t *lane, int use_lane
    // a comment (float* ignored)
    extern "C" int k_tick(const float* packet, float* sizes,
                          int32_t* free_cnt, uint8_t* valid, int T,
                          float eps, LANE_PARAMS, void* stream) {
      return 0;
    }

    extern "C" long long k_words(int T) { return T; }
    """

_STATE = """\
    from typing import NamedTuple


    class KState(NamedTuple):
        sizes: object  # f32[T]
        free: object  # i32[W]
        valid: object  # bool[T]
        lane: object  # i32[T]
    """

_WRAPPER = """\
    import ctypes

    import torch

    from tpu_faas_torch.build import check_arg

    _P = ctypes.c_void_p
    _N_PTR = 4
    _LANE_TYPES = [_P, ctypes.c_int]


    def k_tick_impl(packet, st, *, T, eps=1e-3, use_lane=False):
        return st


    class Kernel:
        def __init__(self):
            self._fn = None

        def load(self):
            lib = ctypes.CDLL("libk.so")
            fn = lib.k_tick
            fn.argtypes = ([_P] * _N_PTR + [ctypes.c_int, ctypes.c_float]
                           + _LANE_TYPES + [_P])
            fn.restype = ctypes.c_int
            words = lib.k_words
            words.argtypes = [ctypes.c_int]
            words.restype = ctypes.c_longlong
            self._fn, self._words = fn, words

        def _lane(self, st, use_lane):
            if not use_lane:
                return (None, 0)
            return (st.lane.data_ptr(), 1)

        def __call__(self, packet, st, *, T, eps=1e-3, use_lane=False):
            check_arg(packet, "packet", torch.float32, T, packet.device)
            for name, dtype in (("sizes", torch.float32), ("free", torch.int32),
                                ("valid", torch.bool), ("lane", torch.int32)):
                check_arg(getattr(st, name), name, dtype, T, packet.device)
            lane = self._lane(st, use_lane)
            return self._fn(
                packet.data_ptr(), st.sizes.data_ptr(), st.free.data_ptr(),
                st.valid.data_ptr(), T, eps, *lane, 0,
            )


    KERNEL = Kernel()


    def k_tick(packet, st, **statics):
        if packet.device.type == "cuda":
            return KERNEL(packet, st, **statics)
        return k_tick_impl(packet, st, **statics)
    """

#: (name, file, old, new, rule): one break each of the fixture tree
KP_BREAKS = [
    ("argtypes-count", "sched/k.py", "_N_PTR = 4", "_N_PTR = 3",
     "kernelparity.state-leaf-drift"),
    ("argtypes-kind", "sched/k.py", "[ctypes.c_int, ctypes.c_float]",
     "[ctypes.c_int, ctypes.c_int]", "kernelparity.state-leaf-drift"),
    ("restype", "sched/k.py", "words.restype = ctypes.c_longlong",
     "words.restype = ctypes.c_int", "kernelparity.state-leaf-drift"),
    ("launch-length", "sched/k.py", "T, eps, *lane, 0,", "T, eps, *lane,",
     "kernelparity.state-leaf-drift"),
    ("leaf-order", "sched/k.py", "st.sizes.data_ptr(), st.free.data_ptr()",
     "st.free.data_ptr(), st.sizes.data_ptr()",
     "kernelparity.state-leaf-drift"),
    ("lane-lengths", "sched/k.py", "return (None, 0)", "return (None,)",
     "kernelparity.state-leaf-drift"),
    ("leaf-unconsumed", "sched/state.py", "lane: object  # i32[T]",
     "lane: object  # i32[T]\n    extra: object  # f32[T]",
     "kernelparity.state-leaf-drift"),
    ("pointer-at-scalar", "csrc/k.cu", "uint8_t* valid, int T",
     "int valid, int T", "kernelparity.state-leaf-drift"),
    ("pointer-type", "csrc/k.cu", "float* sizes", "int32_t* sizes",
     "kernelparity.state-dtype-drift"),
    ("macro-pointer-type", "csrc/k.cu", "int32_t *lane", "float *lane",
     "kernelparity.state-dtype-drift"),
    ("wrapper-dtype", "csrc/k.cu", "const float* packet", "const int* packet",
     "kernelparity.state-dtype-drift"),
    ("check-arg-dtype", "sched/k.py", '("free", torch.int32)',
     '("free", torch.float32)', "kernelparity.state-dtype-drift"),
    ("kernel-keyword", "sched/k.py",
     "def __call__(self, packet, st, *, T, eps=1e-3, use_lane=False):",
     "def __call__(self, packet, st, *, T, eps=1e-3, use_lane=False,\n"
     "                 use_new=False):",
     "kernelparity.twin-signature-drift"),
    ("plain-required", "sched/k.py",
     "def k_tick_impl(packet, st, *, T, eps=1e-3, use_lane=False):",
     "def k_tick_impl(packet, st, *, T, W, eps=1e-3, use_lane=False):",
     "kernelparity.twin-signature-drift"),
]


def kp_tree(root: Path) -> Path:
    write(root, "csrc/k.cu", _CU)
    write(root, "sched/state.py", _STATE)
    write(root, "sched/k.py", _WRAPPER)
    return root


def test_kernelparity_fixture_tree_is_clean(tmp_path):
    kp_tree(tmp_path)
    checker = KernelParityChecker()
    assert run_paths([tmp_path], checker_classes=[lambda: checker]) == []
    assert [len(l.args) for l in checker.launches] == [9]
    assert len(checker.c_sigs["k_tick"].params) == 9
    assert {(b.symbol, b.what) for b in checker.bindings} == {
        ("k_tick", "argtypes"), ("k_tick", "restype"),
        ("k_words", "argtypes"), ("k_words", "restype")}


@pytest.mark.parametrize("name,rel,old,new,rule", KP_BREAKS,
                         ids=[b[0] for b in KP_BREAKS])
def test_kernelparity_fixture_break_fires(tmp_path, name, rel, old, new,
                                          rule):
    kp_tree(tmp_path)
    p = tmp_path / rel
    text = p.read_text()
    assert text.count(old) == 1, name
    p.write_text(text.replace(old, new))
    found = only(tmp_path, KernelParityChecker)
    assert rule in {f.rule for f in found}, found
    assert all(f.severity == "error" for f in found)


def test_kernelparity_forwarding_wrapper_names(tmp_path):
    """A wrapper that forwards its parameters to a plain version must carry
    its parameter names (``bid_top2`` and ``bid_top2_stream_impl``)."""
    src = """\
        def bid_impl(task_size, price, row_offset=0):
            return task_size


        def bid(task_size, price, row_offset=0):
            return bid_impl(task_size, price, row_offset)
        """
    write(tmp_path, "b.py", src)
    assert only(tmp_path, KernelParityChecker) == []
    write(tmp_path, "b.py", src.replace("def bid(task_size, price,",
                                        "def bid(task_size, prices,")
          .replace("return bid_impl(task_size, price,",
                   "return bid_impl(task_size, prices,"))
    assert hits(only(tmp_path, KernelParityChecker)) == [
        ("kernelparity.twin-signature-drift", 6)]


def test_kernelparity_suppressible(tmp_path):
    kp_tree(tmp_path)
    p = tmp_path / "sched" / "k.py"
    text = p.read_text().replace("_N_PTR = 4", "_N_PTR = 3")
    line = "fn.argtypes = ([_P] * _N_PTR + [ctypes.c_int, ctypes.c_float]"
    assert text.count(line) == 1
    p.write_text(text.replace(line, line + "  # faas: allow("
                              "kernelparity.state-leaf-drift) a fixture's "
                              "deliberate drift"))
    assert only(tmp_path, KernelParityChecker) == []


def _real_tree(tmp_path: Path) -> Path:
    """A scratch copy of the real B1 wrapper, its plain version's module
    (the registry) and its CUDA source."""
    for rel in ("sched/fused_tick.py", "sched/resident.py",
                "csrc/fused_tick.cu", "csrc/bid_top2.cuh"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(PORT / rel, tmp_path / rel)
    return tmp_path


#: (name, file, old, new, rule): the three breaks of the real B1 binding
REAL_BREAKS = [
    ("argtypes-count", "sched/fused_tick.py", "_N_PTR = 13  #",
     "_N_PTR = 12  #", "kernelparity.state-leaf-drift"),
    ("swapped-leaves", "sched/fused_tick.py",
     "st.free.data_ptr(), st.inflight.data_ptr()",
     "st.inflight.data_ptr(), st.free.data_ptr()",
     "kernelparity.state-leaf-drift"),
    ("pointer-type", "csrc/fused_tick.cu",
     "float* speed, uint8_t* active, int32_t* out_i32, uint8_t* out_b8,\n"
     "    int32_t* scratch, int T",
     "int32_t* speed, uint8_t* active, int32_t* out_i32, uint8_t* out_b8,\n"
     "    int32_t* scratch, int T",
     "kernelparity.state-dtype-drift"),
]


def test_kernelparity_real_binding_copy_is_clean(tmp_path):
    _real_tree(tmp_path)
    assert only(tmp_path, KernelParityChecker) == []


@pytest.mark.parametrize("name,rel,old,new,rule", REAL_BREAKS,
                         ids=[b[0] for b in REAL_BREAKS])
def test_kernelparity_real_binding_break_is_caught(tmp_path, name, rel, old,
                                                   new, rule):
    _real_tree(tmp_path)
    p = tmp_path / rel
    text = p.read_text()
    assert old in text, name
    p.write_text(text.replace(old, new, 1))
    found = only(tmp_path, KernelParityChecker)
    assert rule in {f.rule for f in found}, found
    assert all(f.severity == "error" for f in found)
    assert any(f.path.endswith("fused_tick.py") for f in found)


def test_kernelparity_real_tree_pin():
    """The port's bindings as the checker reads them: the 16-leaf registry,
    every bound symbol with its argtypes, the five launches as long as
    their C signatures, and no finding."""
    checker = KernelParityChecker()
    for rel in ("sched/resident.py", "sched/fused_tick.py", "sched/bid.py"):
        path = PORT / rel
        list(checker.check(Module.parse(path, rel, path.read_text())))
    assert list(checker.finalize()) == []
    assert {r.name: r.leaves for r in checker.registries} == {
        "_ResidentState": [
            "sizes", "valid", "prio", "tenant", "last_hb", "free",
            "inflight", "prev_live", "speed", "active", "price",
            "t_deficit", "infl_start", "infl_pred", "avoid", "refresh",
        ]}
    argtypes = {b.symbol: len(b.kinds) for b in checker.bindings
                if b.what == "argtypes"}
    assert len(argtypes) == 14
    assert {s: argtypes[s] for s in (
        "tpu_faas_fused_resident_tick", "tpu_faas_fused_resident_auction",
        "tpu_faas_fused_resident_sinkhorn", "tpu_faas_bid_top2")} == {
        "tpu_faas_fused_resident_tick": 43,
        "tpu_faas_fused_resident_auction": 47,
        "tpu_faas_fused_resident_sinkhorn": 49, "tpu_faas_bid_top2": 14}
    assert sorted((l.symbol, len(l.args)) for l in checker.launches) == [
        ("tpu_faas_bid_top2", 14), ("tpu_faas_fused_resident_auction", 47),
        ("tpu_faas_fused_resident_sinkhorn", 49),
        ("tpu_faas_fused_resident_tick", 43), ("tpu_faas_math_probe", 5)]
    for sym, n in argtypes.items():
        assert len(checker.c_sigs[sym].params) == n, sym


# -- devicesnapshot: asynchronous uploads ------------------------------------

@pytest.mark.parametrize("upload", [
    "t = torch.from_numpy(a).to(dev, non_blocking=True)",
    "t = torch.from_numpy(a).cuda(non_blocking=True)",
    "t = torch.as_tensor(a).pin_memory().to(dev, non_blocking=True)",
    "v = torch.from_numpy(a)\n    t = v.to(dev, non_blocking=True)",
    "t = torch.empty(4, device=dev)\n    t.copy_(torch.from_numpy(a), "
    "non_blocking=True)",
])
def test_devicesnapshot_async_upload_then_mutation_fires(tmp_path, upload):
    write(tmp_path, "up.py", textwrap.dedent("""\
        import torch


        def tick(a, dev):
            UPLOAD
            a[0] = 1.0
            return t
        """).replace("UPLOAD", upload))
    found = only(tmp_path, DeviceSnapshotChecker)
    assert [f.rule for f in found] == ["devicesnapshot.unsnapshotted-upload"]


def test_devicesnapshot_mutation_forms_fire(tmp_path):
    write(tmp_path, "up.py", """\
        import torch


        def tick(self, dev):
            t = torch.from_numpy(self.free).to(dev, non_blocking=True)
            self.free += 1
            u = torch.from_numpy(self.hb).to(dev, non_blocking=True)
            self.hb.fill(0.0)
            return t, u
        """)
    assert hits(only(tmp_path, DeviceSnapshotChecker)) == [
        ("devicesnapshot.unsnapshotted-upload", 5),
        ("devicesnapshot.unsnapshotted-upload", 7),
    ]


def test_devicesnapshot_snapshots_and_blocking_copies_are_clean(tmp_path):
    write(tmp_path, "up.py", """\
        import numpy as np
        import torch

        from tpu_faas_torch.device import upload


        def tick(a, b, c, d, e, dev):
            a[1] = 2.0  # mutated before the upload: clean
            t1 = torch.from_numpy(a).to(dev, non_blocking=True)
            t2 = torch.from_numpy(b.copy()).to(dev, non_blocking=True)
            t3 = upload(c, dev)
            t4 = torch.from_numpy(d).to(dev)
            t5 = torch.from_numpy(np.array(e)).to(dev, non_blocking=True)
            b[0] = c[0] = d[0] = e[0] = 1.0
            return t1, t2, t3, t4, t5


        def rebound(a, dev):
            t = torch.from_numpy(a).to(dev, non_blocking=True)
            a = a.copy()
            a[0] = 1.0
            return t
        """)
    assert only(tmp_path, DeviceSnapshotChecker) == []


def test_devicesnapshot_scopes_are_independent_and_suppressible(tmp_path):
    write(tmp_path, "up.py", """\
        import torch


        def outer(a, dev):
            t = torch.from_numpy(a).to(dev, non_blocking=True)  # faas: allow(devicesnapshot.unsnapshotted-upload) the stream is synchronized before the write

            def inner():
                a[0] = 1.0

            a[1] = 2.0
            return t, inner
        """)
    assert only(tmp_path, DeviceSnapshotChecker) == []


def test_devicesnapshot_the_port_uploads_snapshots():
    findings = run_paths([PORT / "sched", PORT / "device.py",
                          PORT / "dispatch" / "tpu_push.py",
                          PORT / "parallel"],
                         checker_classes=[DeviceSnapshotChecker])
    assert findings == []


# -- the port's forms of the JAX cases that key on paths ---------------------

def test_protocol_store_package_is_exempt(tmp_path):
    pkg = tmp_path / "tpu_faas_torch" / "store"
    write(pkg, "impl.py", """\
        def f(store, tid):
            store.hset(tid, {"status": "QUEUED"})
            store.publish("tasks", tid)
        """)
    assert run_paths([pkg]) == []
    assert run_paths([pkg / "impl.py"]) == []
    # the JAX package's store directory is not the port's
    jax_pkg = tmp_path / "tpu_faas" / "store"
    write(jax_pkg, "impl.py", "def f(s, t):\n    s.publish('tasks', t)\n")
    assert [f.rule for f in run_paths([jax_pkg])] == [
        "protocol.raw-task-publish"]


def test_shard_store_package_may_mix_routing(tmp_path):
    src = """\
        from tpu_faas_torch.store.base import LIVE_INDEX_KEY

        def fan(store, digest):
            store.hgetall_many([LIVE_INDEX_KEY, f"blob:{digest}"])
        """
    write(tmp_path / "tpu_faas_torch" / "store", "impl.py", src)
    findings = run_paths([tmp_path / "tpu_faas_torch"])
    assert [f for f in findings
            if f.rule == "shard.mixed-routing-pipeline"] == []
    # the same mix outside the port's store package is a finding
    write(tmp_path / "other", "impl.py", src)
    assert [f.rule for f in run_paths([tmp_path / "other"])
            if f.rule.startswith("shard.")] == ["shard.mixed-routing-pipeline"]


def test_registry_drift_finds_the_native_table_from_the_port():
    """The registries checker walks up from the port's store modules to
    ``native/store_server.cpp``, and the port's five registries agree with
    it."""
    from tpu_faas_torch.analysis.registries import RegistryChecker

    checker = RegistryChecker()
    for name in ("store/server.py", "store/replication.py",
                 "store/sharding.py", "store/racecheck.py"):
        p = PORT / name
        list(checker.check(Module.parse(p, name, p.read_text())))
    assert sorted(r.kind for r in checker._registries) == [
        "apply", "dispatch", "forward", "native", "racecheck", "sharded"]
    assert list(checker.finalize()) == []


def test_sarif_carries_the_rewritten_rule_ids(tmp_path, capsys):
    write(tmp_path, "sched/bid.py", """\
        import torch


        def bid_top2(x: torch.Tensor, a, dev):
            t = torch.from_numpy(a).to(dev, non_blocking=True)
            a[0] = 1.0
            return x.item(), t
        """)
    out = tmp_path / "out.sarif"
    assert analysis_main(["--sarif", str(out), str(tmp_path)]) == 1
    capsys.readouterr()
    run = json.loads(out.read_text())["runs"][0]
    rules = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert rules == {"trace.host-sync", "devicesnapshot.unsnapshotted-upload"}


# -- the CLI in a fresh interpreter -------------------------------------------

_FRESH = """\
import json, sys
from tpu_faas_torch.analysis.__main__ import main
rc = main(sys.argv[1:])
print(json.dumps(dict(rc=rc, loaded=sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("torch", "jax", "jaxlib", "tpu_faas")))))
"""


def _fresh(*args: str) -> tuple[dict, str]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", _FRESH, *args],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stdout


def test_cli_in_a_fresh_interpreter_loads_no_torch_jax_or_jax_package():
    res, out = _fresh(str(PORT))
    assert res == {"rc": 0, "loaded": []}
    assert "tpu_faas_torch.analysis: 0 error(s), 0 warning(s)" in out


def test_cli_module_entry_exit_codes(tmp_path):
    write(tmp_path, "sched/bid.py", """\
        import torch


        def bid_top2(x: torch.Tensor):
            return x.item()
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)

    def run(*args):
        return subprocess.run(
            [sys.executable, "-m", "tpu_faas_torch.analysis", *args],
            capture_output=True, text=True, cwd=REPO, env=env, timeout=300)

    bad = run(str(tmp_path))
    assert bad.returncode == 1 and "trace.host-sync" in bad.stdout
    assert run("--only", "obs", str(tmp_path)).returncode == 0
    assert run("--only", "nosuch", str(tmp_path)).returncode == 2
    assert run(str(tmp_path / "missing")).returncode == 2
    default = run("--only", "kernelparity")
    assert default.returncode == 0
    assert "0 error(s), 0 warning(s)" in default.stdout


# -- sched/problem.py against JAX's PlacementProblem -------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placement_problem_matches_jax(seed):
    from tpu_faas.sched import problem as jp

    from tpu_faas_torch.sched import problem as tp

    rng = np.random.default_rng(seed)
    n_t, n_w = int(rng.integers(1, 300)), int(rng.integers(1, 40))
    sizes = rng.lognormal(0.0, 1.0, n_t).astype(np.float32)
    speeds = rng.uniform(0.5, 4.0, n_w).astype(np.float32)
    free = rng.integers(0, 8, n_w).astype(np.int32)
    live = rng.random(n_w) < 0.8 if seed else None
    kw = dict(T=512, W=64) if seed == 2 else {}
    want = jp.PlacementProblem.build(sizes, speeds, free, live, **kw)
    got = tp.PlacementProblem.build(sizes, speeds, free, live, **kw,
                                    device="cpu")
    assert (got.T, got.W) == (want.T, want.W)
    for name in ("task_size", "task_valid", "worker_speed", "worker_free",
                 "worker_live"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for n, bucket in ((0, 256), (1, 256), (256, 256), (257, 256), (5, 8)):
        assert tp.pad_to(n, bucket) == jp.pad_to(n, bucket)


def test_placement_problem_runs_on_the_card_by_default():
    import torch

    from tpu_faas_torch.sched.problem import PlacementProblem

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlacementProblem.build([1.0], [1.0], [1])
