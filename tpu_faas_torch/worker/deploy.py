"""Worker-fleet deployer: spawn, supervise, and cleanly stop N worker nodes.

The reference kept a throwaway multi-worker launcher with SIGINT cleanup in
its scrap heap (reference old/deploy_workers.py:9-108, including an inverted
``--nh`` flag at :34 — not reproduced); this is the production version:

- spawns N worker subprocesses (push or pull protocol) against one
  dispatcher URL;
- optional supervision (``--restart``): a worker that *crashes* is respawned
  after a short backoff — combined with heartbeat purge + in-flight
  re-dispatch on the dispatcher side this gives the fleet self-healing the
  reference lacks (its dead workers stay dead, SURVEY §5.3);
- SIGTERM/SIGINT forward a graceful drain to every worker (deregister,
  finish in-flight, exit 0 — worker/drain.py) and wait; workers that ignore
  the drain are killed after ``--stop-grace`` seconds. A worker that exits 0
  on its own (e.g. drained by an operator) is NOT respawned;
- optional queue-driven autoscaling (``--stats-url`` + ``--min``/``--max``):
  the fleet grows one node per decision while the dispatcher reports
  pending work and gracefully drains a node after a sustained quiet period
  (:class:`AutoScaler`).

Usage::

    python -m tpu_faas_torch.worker.deploy 4 2 tcp://host:5555 --hb --restart \
        --stats-url http://127.0.0.1:9100/stats --min 2 --max 16
"""

from __future__ import annotations

import argparse
import hashlib
import math
import os
import signal
import socket as _socket
import subprocess
import sys
import time

from tpu_faas_torch.utils.logging import get_logger

log = get_logger("worker.deploy")


def fleet_id(dispatcher_url: str) -> str:
    """Short stable id of the fleet a supervisor serves, derived from its
    dispatcher URL. Namespaces the durable worker tokens: two supervisors
    on ONE host serving DIFFERENT dispatchers used to mint identical
    hostname/slot tokens, merging their workers' speed grades in the
    estimator (ADVICE r5) — a machine can be fast for one fleet's
    workload and slow for another's."""
    return hashlib.blake2b(
        dispatcher_url.encode("utf-8", "replace"), digest_size=4
    ).hexdigest()


class WorkerFleet:
    """Owns N worker subprocesses. Not thread-safe; drive from one thread."""

    def __init__(
        self,
        n_workers: int,
        num_processes: int,
        dispatcher_url: str,
        protocol: str = "push",
        heartbeat: bool = False,
        hb_period: float = 1.0,
        delay: float = 0.01,
        restart: bool = False,
        restart_backoff: float = 1.0,
        stop_grace: float = 10.0,
    ) -> None:
        if protocol not in ("push", "pull"):
            raise ValueError(f"unknown protocol {protocol!r}")
        self.n_workers = n_workers
        self.num_processes = num_processes
        self.dispatcher_url = dispatcher_url
        self.protocol = protocol
        self.heartbeat = heartbeat
        self.hb_period = hb_period
        self.delay = delay
        self.restart = restart
        self.restart_backoff = restart_backoff
        self.stop_grace = stop_grace
        self.procs: list[subprocess.Popen | None] = [None] * n_workers
        self.restarts = 0
        self._stopping = False
        #: slot -> monotonic time when its crashed worker may respawn;
        #: non-blocking backoff, so shutdown never waits behind N sleeps
        self._respawn_at: dict[int, float] = {}
        #: slot -> drain deadline (scale_down escalation bookkeeping)
        self._draining: dict[int, float] = {}

    def _command(self, slot: int) -> list[str]:
        mod = f"tpu_faas_torch.worker.{self.protocol}_worker"
        cmd = [sys.executable, "-m", mod, str(self.num_processes), self.dispatcher_url]
        if self.protocol == "push":
            if self.heartbeat:
                cmd += ["--hb", "--hb-period", str(self.hb_period)]
            # host-stable identity: a respawned worker — whether the crash
            # was the worker's OR the whole supervisor's — re-registers
            # under the SAME token, so the estimator's learned speed for
            # this machine slot survives (sched/estimator.py worker
            # grades) instead of relearning from the 1.0 prior. The fleet
            # id (hash of the dispatcher URL) keeps two supervisors on one
            # host from minting colliding tokens and merging grades.
            cmd += [
                "--token",
                f"{_socket.gethostname()}-{fleet_id(self.dispatcher_url)}"
                f"-{self.protocol}{self.num_processes}-slot{slot}",
            ]
        else:
            cmd += ["--delay", str(self.delay)]
        return cmd

    def _spawn(self, slot: int) -> subprocess.Popen:
        # own process group per worker: its pool children + mp helper
        # processes can all be reaped with one killpg if it crashes (a bare
        # SIGKILL on the leader orphans them to pid 1, where they pile up)
        p = subprocess.Popen(
            self._command(slot), cwd=os.getcwd(), start_new_session=True
        )
        log.info("worker[%d] pid %d: %s", slot, p.pid, " ".join(self._command(slot)))
        self.procs[slot] = p
        return p

    @staticmethod
    def _killpg(p: subprocess.Popen) -> None:
        """SIGKILL a worker's whole process group (children + helpers); the
        group persists while any member lives, even after the leader died."""
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            if p.poll() is None:
                p.kill()

    def start(self) -> None:
        for i in range(self.n_workers):
            self._spawn(i)

    # -- elastic sizing (used by AutoScaler) --------------------------------
    def scale_up(self) -> int:
        """Add one worker node NOW; returns its slot index. Reuses a free
        slot if one exists, else grows the table."""
        for i, p in enumerate(self.procs):
            if p is None and i not in self._respawn_at:
                self._spawn(i)
                return i
        self.procs.append(None)
        slot = len(self.procs) - 1
        self._spawn(slot)
        return slot

    def scale_down(self) -> int | None:
        """Gracefully drain one worker (SIGTERM -> deregister + finish
        in-flight + exit 0, which poll() does NOT respawn). Returns the
        drained slot, or None if nothing (new) could be drained.

        Slots already draining are skipped — re-terminating the same
        wedged worker forever would both block further shrink and inflate
        the caller's counters — and a drain that outlives ``stop_grace``
        escalates to a group kill."""
        now = time.monotonic()
        for slot, deadline in list(self._draining.items()):
            p = self.procs[slot] if slot < len(self.procs) else None
            if p is None or p.poll() is not None:
                del self._draining[slot]  # exited; poll() reaps it
            elif now >= deadline:
                log.warning(
                    "scale-down: worker[%d] ignored drain; killing", slot
                )
                self._killpg(p)
                del self._draining[slot]
        for i in range(len(self.procs) - 1, -1, -1):
            p = self.procs[i]
            if p is not None and p.poll() is None and i not in self._draining:
                p.terminate()
                self._draining[i] = now + self.stop_grace
                log.info("scale-down: draining worker[%d] pid %d", i, p.pid)
                return i
        return None

    def poll(self) -> int:
        """Reap exited workers; respawn crashed ones (after their backoff)
        when supervising. Returns the number of currently-live workers."""
        now = time.monotonic()
        for slot in list(self._respawn_at):
            if self._stopping or not self.restart:
                del self._respawn_at[slot]
            elif now >= self._respawn_at[slot]:
                del self._respawn_at[slot]
                self.restarts += 1
                self._spawn(slot)
        live = 0
        for i, p in enumerate(self.procs):
            if p is None:
                continue
            rc = p.poll()
            if rc is None:
                live += 1
                continue
            self.procs[i] = None
            if rc != 0:
                # ANY crash (supervised or not) reaps the dead leader's
                # orphaned pool children/helpers — the pid-1 pile-up this
                # module exists to prevent; a clean exit (rc=0) drained its
                # own pool and needs no group kill
                self._killpg(p)
            if rc == 0 or self._stopping or not self.restart:
                # clean exit (operator drained it) or shutdown: don't revive
                log.info("worker[%d] exited rc=%d", i, rc)
                continue
            log.warning(
                "worker[%d] crashed rc=%d; respawning in %.1fs",
                i, rc, self.restart_backoff,
            )
            self._respawn_at[i] = now + self.restart_backoff
        return live

    def stop(self) -> None:
        """Graceful drain: SIGTERM everyone (workers deregister + finish
        in-flight), wait up to stop_grace, then SIGKILL stragglers."""
        self._stopping = True
        self._respawn_at.clear()
        for p in self.procs:
            if p is not None and p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + self.stop_grace
        for p in self.procs:
            if p is None:
                continue
            remaining = max(0.0, deadline - time.monotonic())
            try:
                p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                log.warning("worker pid %d ignored drain; killing", p.pid)
                self._killpg(p)
                p.wait()
            else:
                if p.returncode != 0:
                    # leader died before the drain without cleaning up:
                    # reap its surviving group members too (the timeout
                    # branch above already group-killed)
                    self._killpg(p)
        self.procs = [None] * len(self.procs)

    @property
    def n_live(self) -> int:
        return sum(1 for p in self.procs if p is not None and p.poll() is None)


class AutoScaler:
    """Queue-driven elastic sizing on top of a :class:`WorkerFleet`.

    Policy (deliberately simple and oscillation-resistant):

    - scale UP when the dispatcher reports pending work (``pending > 0``)
      and the fleet is below ``max_workers`` — the backlog signal already
      accounts for free capacity, because the dispatcher drains pending
      into free slots before stats are read. One node per decision by
      default; when the dispatcher also reports ``backlog_est_s`` (the
      estimator's learned-runtime drain time, tpu-push
      ``_backlog_estimate_s``), enough nodes to drain the backlog within
      ``drain_target_s`` are added at once — a 10-minute estimated backlog
      should not grow the fleet one node per polling period;
    - scale DOWN one node after ``idle_decisions`` consecutive observations
      of a completely quiet system (no pending, nothing in flight) while
      above ``min_workers`` — draining is graceful (SIGTERM), so shrink
      never kills running work.

    ``step(stats)`` takes the dispatcher's ``/stats`` JSON (see
    ``TaskDispatcher.serve_stats``) and returns "up", "down", or None, so
    the policy is unit-testable without HTTP; the CLI feeds it from
    ``--stats-url`` each supervision loop.
    """

    def __init__(
        self,
        fleet: WorkerFleet,
        min_workers: int,
        max_workers: int,
        idle_decisions: int = 5,
        drain_target_s: float = 30.0,
    ) -> None:
        if not 0 < min_workers <= max_workers:
            raise ValueError("need 0 < min_workers <= max_workers")
        self.fleet = fleet
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.idle_decisions = idle_decisions
        #: aim to drain a reported learned-runtime backlog within this many
        #: seconds; only engages when the dispatcher serves backlog_est_s
        self.drain_target_s = float(drain_target_s)
        self._idle_streak = 0
        self._warned_no_queue_stats = False
        self.scale_ups = 0
        self.scale_downs = 0

    def step(self, stats: dict) -> str | None:
        if "pending" not in stats or "inflight" not in stats:
            # stats from a dispatcher that doesn't report queue depth (the
            # classic push/pull modes serve only the base dict): treating
            # absent as 0 would read a loaded fleet as idle and drain it —
            # refuse to decide instead
            if not self._warned_no_queue_stats:
                self._warned_no_queue_stats = True
                log.warning(
                    "stats endpoint reports no pending/inflight (not a "
                    "tpu-push dispatcher?); autoscaling is inert"
                )
            return None
        live = self.fleet.n_live
        pending = int(stats.get("pending", 0))
        inflight = int(stats.get("inflight", 0))
        if live < self.min_workers:
            # enforce the floor even while idle (a crashed worker without
            # --restart must not leave the fleet below --min forever)
            self.fleet.scale_up()
            self.scale_ups += 1
            log.info("autoscale floor: live=%d->%d", live, live + 1)
            return "up"
        if pending > 0:
            self._idle_streak = 0
            if live < self.max_workers:
                # learned-runtime sizing: add enough nodes to drain the
                # estimated backlog within drain_target_s, one node when
                # the dispatcher reports no estimate (estimator off /
                # nothing learned). The desired TOTAL is computed from the
                # dispatcher's REGISTERED worker count — backlog_est_s is
                # measured against registered capacity, while `live`
                # counts locally-spawned processes that may not have
                # registered yet; sizing against `live` would re-multiply
                # an already-grown fleet every decision period until the
                # new nodes register (spawn+register > scale-period jumps
                # straight to max)
                backlog_s = stats.get("backlog_est_s")
                reg = stats.get("workers_registered")
                n_up = 1
                if (
                    isinstance(backlog_s, (int, float))
                    and backlog_s > self.drain_target_s
                    and isinstance(reg, int)
                    and reg > 0
                ):
                    want_total = math.ceil(
                        reg * backlog_s / self.drain_target_s
                    )
                    # current capacity = max(registered, locally spawned):
                    # reg < live while local spawns are still registering
                    # (don't re-count them); reg > live when workers
                    # OUTSIDE this supervisor are registered (don't spawn
                    # the whole cluster's shortfall locally on top of them)
                    n_up = want_total - max(reg, live)
                n_up = min(n_up, self.max_workers - live)
                if n_up <= 0:
                    # provisioned ahead of the (stale) backlog estimate:
                    # wait for the spawned nodes to register
                    return None
                for _ in range(n_up):
                    self.fleet.scale_up()
                self.scale_ups += n_up
                log.info(
                    "autoscale up: pending=%d backlog_est=%s live=%d->%d",
                    pending, stats.get("backlog_est_s"), live, live + n_up,
                )
                return "up"
            return None
        if inflight > 0:
            self._idle_streak = 0
            return None
        self._idle_streak += 1
        if self._idle_streak >= self.idle_decisions and live > self.min_workers:
            self._idle_streak = 0
            if self.fleet.scale_down() is not None:
                self.scale_downs += 1
                log.info("autoscale down: idle, live=%d->%d", live, live - 1)
                return "down"
        return None


def _fetch_stats(url: str) -> dict | None:
    """GET the dispatcher stats JSON; None on any failure (the autoscaler
    simply skips that decision — a dispatcher restart must not kill the
    supervisor)."""
    import json
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=2.0) as r:
            return json.loads(r.read())
    except Exception:
        return None


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="tpu-faas worker fleet deployer")
    ap.add_argument("n_workers", type=int, help="worker nodes to spawn")
    ap.add_argument("num_processes", type=int, help="pool size per worker")
    ap.add_argument("dispatcher_url", help="tcp://host:port of the dispatcher")
    ap.add_argument("--protocol", choices=["push", "pull"], default="push")
    ap.add_argument("--hb", action="store_true", help="push: heartbeats on")
    ap.add_argument("--hb-period", type=float, default=1.0)
    ap.add_argument("--delay", type=float, default=0.01, help="pull pacing")
    ap.add_argument(
        "--restart", action="store_true",
        help="respawn crashed (non-zero-exit) workers",
    )
    ap.add_argument("--restart-backoff", type=float, default=1.0)
    ap.add_argument("--stop-grace", type=float, default=10.0)
    ap.add_argument(
        "--stats-url",
        help="dispatcher stats endpoint (http://host:port/stats) — enables "
        "queue-driven autoscaling between --min and --max workers",
    )
    ap.add_argument("--min", type=int, default=None, help="autoscale floor")
    ap.add_argument("--max", type=int, default=None, help="autoscale ceiling")
    ap.add_argument(
        "--scale-period", type=float, default=2.0,
        help="seconds between autoscale decisions",
    )
    ap.add_argument(
        "--drain-target", type=float, default=30.0,
        help="autoscale sizing goal: drain the dispatcher's learned-"
        "runtime backlog estimate within this many seconds (engages only "
        "when the stats report backlog_est_s)",
    )
    ns = ap.parse_args(argv)

    fleet = WorkerFleet(
        ns.n_workers,
        ns.num_processes,
        ns.dispatcher_url,
        protocol=ns.protocol,
        heartbeat=ns.hb,
        hb_period=ns.hb_period,
        delay=ns.delay,
        restart=ns.restart,
        restart_backoff=ns.restart_backoff,
        stop_grace=ns.stop_grace,
    )

    stop_requested = False

    def on_signal(signum, frame):
        nonlocal stop_requested
        stop_requested = True
        # a foreground Ctrl-C delivers SIGINT to the whole process group:
        # the workers die with rc!=0 at the same instant, and a poll() racing
        # this handler must treat those as shutdown, not crashes to respawn
        fleet._stopping = True

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)

    scaler = None
    if ns.stats_url:
        scaler = AutoScaler(
            fleet,
            min_workers=ns.min if ns.min is not None else ns.n_workers,
            max_workers=ns.max if ns.max is not None else ns.n_workers * 4,
            drain_target_s=ns.drain_target,
        )

    fleet.start()
    log.info(
        "%d %s workers x %d processes -> %s (restart=%s, autoscale=%s)",
        ns.n_workers, ns.protocol, ns.num_processes, ns.dispatcher_url,
        ns.restart, bool(scaler),
    )
    last_scale = 0.0
    try:
        while not stop_requested:
            live = fleet.poll()
            if live == 0 and not ns.restart and scaler is None:
                log.info("all workers exited; deployer done")
                return
            if scaler is not None and time.monotonic() - last_scale >= ns.scale_period:
                stats = _fetch_stats(ns.stats_url)
                if stats is not None:
                    scaler.step(stats)
                last_scale = time.monotonic()
            time.sleep(0.2)
    finally:
        log.info("draining fleet (%d live)", fleet.n_live)
        fleet.stop()


if __name__ == "__main__":
    main()
