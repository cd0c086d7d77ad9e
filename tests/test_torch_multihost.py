"""The port's multi-process path (``tpu_faas_torch/parallel``) over a REAL
two-process gloo group on the CPU, 4 positions each, held to JAX.

The children are this file run as a script (``python
tests/test_torch_multihost.py child <rank> <port> <leg> [placement]``);
they import torch and the port only. Each leg prints lines the parent
compares across ranks and with a single-process reference:

- ``mesh``: ``sharded_scheduler_tick`` over the 8-position mesh — Sinkhorn,
  rank with priorities, the auction through both winner routes — and the
  ring on random bids, then two warm auction ticks through the
  ``MultihostTick`` protocol (JAX's tests/test_multihost.py);
- ``resident``: ``MultihostResidentScheduler``'s packet protocol, the lead
  driving registrations, prioritized arrivals and result churn, the
  follower mirroring every packet, both leaving through the stop opcode
  (JAX's tests/test_multihost_resident.py).

Rank and the auction are held to JAX exactly (the auction on dyadic sizes
and power-of-two speeds, slice 2's contract: tests/test_torch_auction.py),
the Sinkhorn leg to the port's single-process mesh bit for bit.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, W, I = 64, 16, 32
#: no child may outlive this (JAX's own bound on its children)
CHILD_TIMEOUT_S = 240


# -- inputs every process builds from the same seeds -------------------------
def mesh_inputs():
    rng = np.random.default_rng(5)
    sizes = rng.uniform(0.1, 5.0, T).astype(np.float32)
    valid = rng.random(T) > 0.2
    speed = rng.uniform(0.5, 4.0, W).astype(np.float32)
    free = rng.integers(0, 4, W).astype(np.int32)
    hb_age = rng.uniform(0.0, 15.0, W).astype(np.float32)
    inflight = rng.integers(-1, W, I).astype(np.int32)
    prio = np.random.default_rng(6).integers(-2, 3, T).astype(np.int32)
    # the auction's inputs: dyadic sizes, power-of-two speeds
    rng2 = np.random.default_rng(7)
    dsizes = (rng2.integers(1, 21, T) * 0.25).astype(np.float32)
    dspeed = (2.0 ** rng2.integers(-1, 3, W)).astype(np.float32)
    return sizes, valid, speed, free, hb_age, inflight, prio, dsizes, dspeed


def ring_inputs(n=8, S=32):
    rng = np.random.default_rng(9)
    vals = np.array([-np.inf, -0.0, 0.0, 1.5, 2.25, 3.0], np.float32)
    bids = vals[rng.integers(0, len(vals), (n, S))]
    tids = rng.integers(0, 64, (n, S)).astype(np.int32)
    tids[np.isneginf(bids)] = 2**30
    return bids, tids


def warm_inputs():
    rng = np.random.default_rng(8)
    sizes = (rng.integers(1, 21, 20) * 0.25).astype(np.float32)
    speed = (2.0 ** rng.integers(-1, 3, 8)).astype(np.float32)
    return sizes, speed


def fingerprint(a) -> int:
    a = np.asarray(a)
    return int((a * np.arange(1, len(a) + 1)).sum())


def resident_scenario(r) -> tuple[int, int]:
    """Registrations, prioritized arrivals (dyadic sizes), result churn and
    12 ticks; returns (placed, fingerprint). Runs unchanged on the port's
    and JAX's ResidentScheduler."""
    clock = r._clock_box
    rng = np.random.default_rng(0)
    speeds = 2.0 ** rng.integers(-1, 3, 8)
    for i in range(8):
        r.register(b"w%d" % i, 2, speed=float(speeds[i]))
    placed_all = []
    arrival = 0
    for _ in range(12):
        clock[0] += 0.5
        for i in range(8):
            r.heartbeat(b"w%d" % i)
        for _ in range(4):
            r.pending_add(f"t{arrival}", float(rng.integers(1, 21) * 0.25),
                          priority=arrival % 3)
            arrival += 1
        r.tick_resident()
        while (res := r.resolve_next()) is not None:
            for tid, row in res.placed:
                placed_all.append((tid, row))
                # a result arrives at once: the slot frees
                r.worker_free[row] = min(r.worker_free[row] + 1,
                                         int(r.worker_procs[row]))
    fp = sum(zlib.crc32(t.encode()) * (int(w) + 1) % 1000003
             for t, w in placed_all)
    return len(placed_all), fp


# -- the children ------------------------------------------------------------
def _child(rank: int, port: str, leg: str, placement: str) -> None:
    import torch

    from tpu_faas_torch.parallel.distributed import initialize_multihost

    assert initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank, cpu_devices_per_process=4, timeout=120,
    )
    if leg == "resident":
        from tpu_faas_torch.parallel.multihost_resident import (
            MultihostResidentScheduler,
        )

        clock = [100.0]
        r = MultihostResidentScheduler.from_shape(
            max_workers=16, max_pending=64, max_inflight=128, max_slots=4,
            time_to_expire=10.0, placement=placement,
            clock=lambda: clock[0], device="cpu",
        )
        r._clock_box = clock
        assert r.mesh.size == 8
        if rank != 0:
            r.follow_loop(watchdog_timeout=120)
            print("MHRES follower done", flush=True)
            return
        placed, fp = resident_scenario(r)
        r.lead_stop()
        print(f"MHRES lead placed={placed} fingerprint={fp}", flush=True)
        return

    from tpu_faas_torch.parallel import mesh as tm
    from tpu_faas_torch.parallel.multihost_tick import MultihostTick

    mesh = tm.make_mesh(device="cpu")
    assert mesh.size == 8 and len(mesh.devices) == 4
    (sizes, valid, speed, free, hb_age, inflight, prio, dsizes,
     dspeed) = mesh_inputs()
    t = torch.from_numpy
    ones = torch.ones(W, dtype=torch.bool)
    ts, tv, tp, tds = tm.shard_task_arrays(mesh, sizes, valid, prio, dsizes)

    def tick(task_size, spd, **kw):
        return tm.sharded_scheduler_tick(
            mesh, task_size, tv, t(spd), t(free), ones, t(hb_age), ones,
            t(inflight), 10.0, max_slots=4, **kw)

    out = tick(ts, speed, placement="sinkhorn")
    a = out.assignment.numpy()
    print(f"MULTIHOST rank={rank} placed={int((a >= 0).sum())} "
          f"checksum={int(a.sum())} fingerprint={fingerprint(a)} "
          f"purged={int(out.purged.sum())}", flush=True)
    out = tick(ts, speed, placement="rank", task_priority=tp)
    print(f"PRIO rank={rank} fingerprint={fingerprint(out.assignment)}",
          flush=True)
    for route in ("gspmd", "permute"):
        out = tick(tds, dspeed, placement="auction", winner_resolve=route)
        print(f"AUCTION-{route} rank={rank} "
              f"fingerprint={fingerprint(out.assignment)} "
              f"rounds={out.auction_rounds}", flush=True)
    bids, tids = ring_inputs()
    wp, wt = tm.ring_winner_resolve(
        mesh, [t(bids[g]) for g in mesh.local],
        [t(tids[g]) for g in mesh.local])
    print(f"RING rank={rank} "
          f"winners={zlib.crc32(wp[0].numpy().tobytes() + wt[0].numpy().tobytes())}",
          flush=True)

    # two ticks through the lead/follower protocol, the second warm from
    # each process's carried prices
    mt = MultihostTick(max_pending=32, max_workers=8, max_slots=2,
                       placement="auction", device="cpu")
    sizes_w, speed_w = warm_inputs()
    free_w = np.full(8, 2, dtype=np.int32)
    if rank == 0:
        args = (speed_w, free_w, np.ones(8, bool), np.zeros(8, np.float32),
                np.full(4, -1, np.int32), 10.0)
        mt.lead_tick(sizes_w, *args)
        out2 = mt.lead_tick(sizes_w * np.float32(1.5), *args)
        mt.lead_stop()
    else:
        for _ in range(2):
            out2 = mt._run(mt._broadcast(np.zeros(mt.buflen, np.float32)))
        assert mt._run(
            mt._broadcast(np.zeros(mt.buflen, np.float32))) is None
    print(f"WARMAUCTION rank={rank} fingerprint={fingerprint(out2.assignment)}",
          flush=True)


# -- the parent's side -------------------------------------------------------
def _run_children(leg: str, placement: str = "rank") -> list[str]:
    from test_torch_host_copies import reserved_port

    port = reserved_port()
    # one intra-op thread a child, as in the suite's own workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "tests/test_torch_multihost.py", "child",
             str(rank), str(port), leg, placement],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:  # no child loaded a module of JAX or the JAX package
        assert "JAX modules loaded: 0" in out, out[-1500:]
    return outs


def _field(outs, tag, key="fingerprint") -> list[int]:
    return [int(re.search(rf"{tag} rank=\d .*?{key}=(-?\d+)", o).group(1))
            for o in outs]


def test_two_process_global_mesh_sharded_tick():
    """Both ranks agree bit for bit on every leg; rank with priorities and
    both auction routes equal JAX's single-host tick; Sinkhorn equals the
    port's single-process 8-position mesh; the ring equals the
    single-process ring; the warm MultihostTick protocol equals two ticks
    of JAX's SchedulerArrays."""
    import jax.numpy as jnp
    import torch

    from tpu_faas.sched.state import SchedulerArrays as JaxArrays
    from tpu_faas.sched.state import scheduler_tick
    from tpu_faas_torch.parallel import mesh as tm

    outs = _run_children("mesh")
    lines = [re.search(r"MULTIHOST rank=\d (.*)", o).group(1) for o in outs]
    assert lines[0] == lines[1], lines
    for tag in ("PRIO", "AUCTION-gspmd", "AUCTION-permute", "WARMAUCTION"):
        fps = _field(outs, tag)
        assert fps[0] == fps[1], (tag, fps)
    ring = [re.search(r"RING rank=\d winners=(\d+)", o).group(1)
            for o in outs]
    assert ring[0] == ring[1]

    (sizes, valid, speed, free, hb_age, inflight, prio, dsizes,
     dspeed) = mesh_inputs()
    ones = jnp.ones(W, dtype=bool)

    def jtick(sz, spd, **kw):
        out = scheduler_tick(
            jnp.asarray(sz), jnp.asarray(valid), jnp.asarray(spd),
            jnp.asarray(free), ones, jnp.asarray(hb_age), ones,
            jnp.asarray(inflight), jnp.float32(10.0), max_slots=4, **kw)
        return fingerprint(out.assignment)

    assert _field(outs, "PRIO")[0] == jtick(
        sizes, speed, placement="rank", task_priority=jnp.asarray(prio))
    want = jtick(dsizes, dspeed, placement="auction")
    assert _field(outs, "AUCTION-gspmd")[0] == want
    assert _field(outs, "AUCTION-permute")[0] == want
    assert (_field(outs, "AUCTION-gspmd", "rounds")
            == _field(outs, "AUCTION-permute", "rounds"))

    # the single-process mesh of 8 positions gives the same Sinkhorn
    mesh = tm.make_mesh(8, device="cpu")
    t = torch.from_numpy
    ts, tv = tm.shard_task_arrays(mesh, sizes, valid)
    tones = torch.ones(W, dtype=torch.bool)
    one = tm.sharded_scheduler_tick(
        mesh, ts, tv, t(speed), t(free), tones, t(hb_age), tones,
        t(inflight), 10.0, max_slots=4, placement="sinkhorn")
    a = one.assignment.numpy()
    assert lines[0] == (f"placed={int((a >= 0).sum())} checksum={int(a.sum())}"
                        f" fingerprint={fingerprint(a)} "
                        f"purged={int(one.purged.sum())}")
    bids, tids = ring_inputs()
    wp, wt = tm.ring_winner_resolve(mesh, [t(b) for b in bids],
                                    [t(x) for x in tids])
    assert int(ring[0]) == zlib.crc32(wp[0].numpy().tobytes()
                                      + wt[0].numpy().tobytes())

    arr = JaxArrays(max_workers=8, max_pending=32, max_slots=2,
                    placement="auction", clock=lambda: 100.0)
    sizes_w, speed_w = warm_inputs()
    for i in range(8):
        arr.register(f"w{i}".encode(), 2, speed=float(speed_w[i]))
    arr.tick(sizes_w)
    out2 = arr.tick(sizes_w * np.float32(1.5))
    assert _field(outs, "WARMAUCTION")[0] == fingerprint(out2.assignment)


def _jax_resident_reference(placement: str) -> tuple[int, int]:
    from tpu_faas.sched.resident import ResidentScheduler

    clock = [100.0]
    r = ResidentScheduler(
        max_workers=16, max_pending=64, max_inflight=128, max_slots=4,
        time_to_expire=10.0, clock=lambda: clock[0], use_priority=True,
        placement=placement,
    )
    r._clock_box = clock
    return resident_scenario(r)


@pytest.mark.parametrize("placement", ["rank", "auction"])
def test_two_process_resident_packet_protocol(placement):
    """Both ranks leave through the stop opcode, and the lead's placements
    equal one JAX ResidentScheduler fed the same scenario: the packet
    protocol adds no semantics."""
    outs = _run_children("resident", placement)
    m = re.search(r"MHRES lead placed=(\d+) fingerprint=(\d+)", outs[0])
    assert m, outs[0][-1500:]
    assert "MHRES follower done" in outs[1], outs[1][-1500:]
    assert "stop after 12 packets" in outs[1], outs[1][-1500:]
    got = (int(m.group(1)), int(m.group(2)))
    assert got == _jax_resident_reference(placement)


def test_multihost_tick_host_side_redispatch_matches_kernel():
    """lead_tick computes redispatch on the host (the in-flight table does
    not ride the broadcast); it equals JAX's tick on the same inputs. One
    process, 8 CPU positions: the broadcast is the identity."""
    import jax.numpy as jnp

    from tpu_faas.sched.state import scheduler_tick
    from tpu_faas_torch.parallel import distributed
    from tpu_faas_torch.parallel.multihost_tick import MultihostTick

    rng = np.random.default_rng(9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(distributed._state, "cpu_positions", 8)
        mt = MultihostTick(max_pending=60, max_workers=W, max_slots=4,
                           device="cpu")
    assert mt.mesh.size == 8 and mt.T == 64
    n, I2 = 40, 48
    sizes = rng.uniform(0.1, 5.0, n).astype(np.float32)
    speed = rng.uniform(0.5, 4.0, W).astype(np.float32)
    free = rng.integers(0, 4, W).astype(np.int32)
    active = np.ones(W, dtype=bool)
    hb_age = rng.uniform(0.0, 15.0, W).astype(np.float32)  # some dead
    inflight = rng.integers(-1, W, I2).astype(np.int32)
    out = mt.lead_tick(sizes, speed, free, active, hb_age, inflight, 10.0)
    padded = np.zeros(mt.T, dtype=np.float32)
    padded[:n] = sizes
    ref = scheduler_tick(
        jnp.asarray(padded), jnp.arange(mt.T) < n, jnp.asarray(speed),
        jnp.asarray(free), jnp.asarray(active), jnp.asarray(hb_age),
        jnp.zeros(W, dtype=bool), jnp.asarray(inflight), jnp.float32(10.0),
        max_slots=4,
    )
    np.testing.assert_array_equal(out.assignment, np.asarray(ref.assignment))
    np.testing.assert_array_equal(out.live, np.asarray(ref.live))
    np.testing.assert_array_equal(out.redispatch,
                                  np.asarray(ref.redispatch))
    assert out.redispatch.any()  # the case is not trivial


def test_lead_mid_tick_failure_marks_fleet_broken(monkeypatch):
    """A lead failure AFTER the broadcast marks the fleet broken: later
    ticks refuse at once, and lead_stop issues no (mismatched) stop."""
    from tpu_faas_torch.parallel.multihost_tick import MultihostTick

    mt = MultihostTick(max_pending=32, max_workers=8, max_slots=2,
                       device="cpu")
    broadcasts = []
    monkeypatch.setattr(mt, "_broadcast",
                        lambda buf: broadcasts.append(1) or buf)

    def boom(buf):
        raise RuntimeError("kernel error mid-tick")

    monkeypatch.setattr(mt, "_run", boom)
    args = (np.ones(4, np.float32), np.ones(8, np.float32),
            np.ones(8, np.int32), np.ones(8, bool), np.zeros(8, np.float32),
            np.full(4, -1, np.int32), 10.0)
    with pytest.raises(RuntimeError, match="kernel error"):
        mt.lead_tick(*args)
    assert mt._broken
    n = len(broadcasts)
    with pytest.raises(RuntimeError, match="restarted"):
        mt.lead_tick(*args)
    mt.lead_stop()
    assert len(broadcasts) == n


def test_resident_lead_failure_marks_fleet_broken(monkeypatch):
    from tpu_faas_torch.parallel.multihost_resident import (
        MultihostResidentScheduler,
    )

    r = MultihostResidentScheduler.from_shape(
        max_workers=8, max_pending=16, max_inflight=16, max_slots=2,
        time_to_expire=10.0, placement="rank", device="cpu")
    assert not r.supports_bulk_load
    with pytest.raises(RuntimeError, match="packet protocol"):
        r.pending_bulk_load(["a"], np.ones(1, np.float32))
    broadcasts = []
    monkeypatch.setattr(r, "_broadcast",
                        lambda buf: broadcasts.append(1) or buf)

    def boom(packet):
        raise RuntimeError("kernel error mid-tick")

    monkeypatch.setattr(r, "_apply_packet", boom)
    r.pending_add("t0", 1.0)
    with pytest.raises(RuntimeError, match="kernel error"):
        r.tick_resident()
    with pytest.raises(RuntimeError, match="restart the fleet"):
        r.tick_resident()
    r.lead_stop()
    assert len(broadcasts) == 1


def test_initialize_multihost_contract(monkeypatch):
    """JAX's contract: idempotent; num_processes=1 is a no-op; a named
    cluster's init error raises and latches nothing; discovery that finds
    no cluster runs alone. The coordinator maps to tcp://."""
    import torch
    import torch.distributed as dist

    from tpu_faas_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_state", {
        "initialized": False, "cpu_positions": None, "local_rank": 0})
    calls = []

    def refuse(**kw):
        calls.append(kw)
        raise RuntimeError("no rendezvous")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="no rendezvous"):
        distributed.initialize_multihost("10.0.0.1:1234", 2, 1)
    assert calls[-1]["init_method"] == "tcp://10.0.0.1:1234"
    assert calls[-1]["backend"] == "gloo"
    assert not distributed._state["initialized"]  # a retry can succeed
    assert distributed.initialize_multihost() is False  # env://: alone
    assert calls[-1]["init_method"] == "env://"
    assert distributed._state["initialized"]
    assert distributed.initialize_multihost("10.0.0.1:1234", 2, 1) is False
    assert len(calls) == 2  # idempotent: no third attempt

    monkeypatch.setattr(distributed, "_state", {
        "initialized": False, "cpu_positions": None, "local_rank": 0})
    assert distributed.initialize_multihost(
        num_processes=1, cpu_devices_per_process=3) is False
    assert len(calls) == 2
    assert distributed.local_devices("cpu") == [torch.device("cpu")] * 3


def test_process_device_is_local_rank_modulo_the_cards(monkeypatch):
    import torch

    from tpu_faas_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_state", {
        "initialized": True, "cpu_positions": None, "local_rank": 3})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.process_device("cuda") == torch.device("cuda", 1)
    assert distributed.process_device("cpu") == torch.device("cpu")
    assert distributed.local_devices("cuda") == [torch.device("cuda", 1)]


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    # leave the group before exit: left to interpreter teardown, gloo's
    # threads could abort a child that had finished (SIGABRT, ROADMAP C.7)
    from tpu_faas_torch.parallel import distributed

    distributed.shutdown()
    jax_modules = [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "tpu_faas")]
    print(f"JAX modules loaded: {len(jax_modules)}", flush=True)
