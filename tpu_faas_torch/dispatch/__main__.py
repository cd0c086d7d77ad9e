"""Dispatcher CLI (analog of reference task_dispatcher.py:474-545).

    python -m tpu_faas_torch.dispatch -m local -w 4 --store resp://127.0.0.1:6380
    python -m tpu_faas_torch.dispatch -m pull -p 5555
    python -m tpu_faas_torch.dispatch -m push -p 5555 [--hb] [--plb]
    python -m tpu_faas_torch.dispatch -m tpu-push -p 5555 [--resident]
    python -m tpu_faas_torch.dispatch -m tpu-push --device cpu

    python -m tpu_faas_torch.dispatch -m tpu-push --mesh N [--resident]
    python -m tpu_faas_torch.dispatch -m tpu-push --multihost [--resident] \
        --coordinator HOST:PORT --process-id R --num-processes P

Modes local, pull and push are host code: they touch no device and never
import torch. Only tpu-push schedules on a device: its tick runs on
``--device`` (``cuda`` by default; without a GPU that raises).
``--multihost`` joins a ``torch.distributed`` process group before
anything else starts: process 0 serves, the others follow its ticks and
exit when it stops; ``--dist-backend`` picks the group's backend (NCCL on
cards, gloo on the CPU by default; gloo on cards stages every collective
through host memory, the route for two processes on one card).
"""

from __future__ import annotations

import argparse
import sys
import time

from tpu_faas_torch.utils.config import Config
from tpu_faas_torch.utils.logging import get_logger

log = get_logger("dispatch.cli")


def _install_stop_signals(dispatcher) -> None:
    """SIGTERM/SIGINT -> graceful stop: the serve loop exits at its next
    poll timeout, so shutdown work in its ``finally`` (closing sockets,
    releasing multihost followers from their blocking collective via the
    stop broadcast) actually runs. A bare SIGTERM default would kill the
    process mid-collective and strand every follower in the fleet.

    SIGTERM additionally dumps the flight-recorder ring (obs/flightrec.py)
    through the log before stopping — a killed dispatcher leaves its last
    seconds of tick/hedge/shed context behind for the post-mortem."""
    import signal

    def handler(signum, frame):
        log.info("signal %d: stopping dispatcher", signum)
        if signum == signal.SIGTERM:
            rec = getattr(dispatcher, "flightrec", None)
            if rec is not None:
                try:
                    log.warning("flightrec SIGTERM dump: %s", rec.dump_json())
                except Exception:
                    pass  # the dump must never block the shutdown
        dispatcher.stop()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)


def main(argv: list[str] | None = None) -> None:
    cfg = Config.load()
    ap = argparse.ArgumentParser(description="tpu-faas task dispatcher")
    ap.add_argument(
        "-m",
        "--mode",
        required=True,
        choices=["local", "pull", "push", "tpu-push"],
    )
    ap.add_argument(
        "-p", "--port", type=int, default=cfg.dispatcher_port,
        help="worker-facing port",
    )
    ap.add_argument("-i", "--ip", default=cfg.dispatcher_ip, help="worker-facing bind ip")
    ap.add_argument("-w", "--num-workers", type=int, default=4, help="local pool size")
    ap.add_argument("--store", default=cfg.store_url)
    ap.add_argument("--hb", action="store_true", help="push: heartbeat mode")
    ap.add_argument("--plb", action="store_true", help="push: process-level balancing")
    ap.add_argument(
        "--tte", type=float, default=cfg.time_to_expire,
        help="seconds of heartbeat silence before a worker is purged",
    )
    ap.add_argument(
        "--max-task-retries", type=int, default=3,
        help="reclaims from dead workers before a task is FAILED (poison guard)",
    )
    ap.add_argument(
        "-d", "--delay", type=float, default=0.0, help="startup delay seconds"
    )
    ap.add_argument(
        "--stats-port", type=int, default=0,
        help="serve the observability surface on this port — GET /stats (JSON), /metrics (Prometheus), /trace/<task_id> (lifecycle timeline); 0 = off",
    )
    ap.add_argument(
        "--rescan", type=float, default=10.0,
        help="tpu-push: seconds between stranded-task rescans (0 = off)",
    )
    ap.add_argument(
        "--tick-period", type=float, default=cfg.tick_period,
        help="tpu-push: scheduler tick period (s)",
    )
    ap.add_argument(
        "--max-pending", type=int, default=cfg.max_pending,
        help="tpu-push: padded device batch size (tasks per tick)",
    )
    ap.add_argument(
        "--max-fleet", type=int, default=cfg.max_workers,
        help="tpu-push: padded worker-fleet size",
    )
    ap.add_argument(
        "--max-inflight", type=int, default=65536,
        help="tpu-push: in-flight table capacity (lead-local: the table "
        "never rides the multihost broadcast)",
    )
    ap.add_argument(
        "--max-slots", type=int, default=8,
        help="tpu-push: per-worker process slots considered per tick "
        "(multihost: part of the shape contract)",
    )
    ap.add_argument(
        "--placement", choices=["rank", "auction", "sinkhorn"], default="rank",
        help="tpu-push: placement kernel (rank = Monge-optimal default with "
        "priority classes; auction = general costs; sinkhorn = soft "
        "heterogeneous balancing)",
    )
    ap.add_argument(
        "--no-runtime-learning", action="store_true",
        help="tpu-push: disable the runtime-estimation loop (learned "
        "per-function sizes + per-worker speeds feeding the placement "
        "cost matrix; on by default)",
    )
    ap.add_argument(
        "--resident", action="store_true",
        help="tpu-push: keep ALL scheduler state (pending set, heartbeat "
        "stamps, free counts, worker speed/active, in-flight table) "
        "device-resident between ticks; each tick uploads one small delta "
        "packet instead of the whole batch. The steady-state "
        "high-throughput path; composes with --mesh (task axis of the "
        "resident state sharded over the devices) AND --multihost (the "
        "delta packet becomes the per-tick broadcast; state shards over "
        "the global mesh)",
    )
    ap.add_argument(
        "--tick-backend", default=None,
        choices=("xla", "fused", "fused_interpret"),
        help="accepted and unused: on cuda every --resident tick is one "
        "launch of the fused tick kernel, on cpu its plain version",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="tpu-push only: where the scheduling tick runs; cuda raises "
        "without a GPU, cpu runs the plain PyTorch path (local, pull and "
        "push touch no device and ignore it)",
    )
    ap.add_argument(
        "--dist-backend", default=None, choices=("nccl", "gloo"),
        help="--multihost: the process group's backend (default: nccl on "
        "cuda, gloo on cpu); gloo on cuda stages each collective through "
        "host memory, the only route for two processes on one card",
    )
    ap.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="tpu-push: shard the pending-task axis over N positions (N "
        "cards on cuda, N host positions on cpu; all placements — rank, "
        "sinkhorn, auction — run sharded); 0 = single device",
    )
    mh = ap.add_argument_group(
        "multihost",
        "tpu-push: span the placement mesh across several OS processes "
        "(pod-slice hosts). Start one process per host with the SAME "
        "shape flags; process 0 becomes the serving dispatcher (the "
        "lead), the rest join as mesh followers and exit when the lead "
        "stops. On Cloud TPU the coordinator/process-id/num-processes "
        "triple is auto-discovered; off-TPU pass all three.",
    )
    mh.add_argument(
        "--multihost", action="store_true",
        help="join/form the multi-process global mesh before serving",
    )
    mh.add_argument(
        "--follower-watchdog", type=float, default=900.0, metavar="S",
        help="followers: hard-exit if one tick's collectives block longer "
        "than this (lead died mid-tick — a blocked collective is not "
        "interruptible). Set above the first tick's cold-compile time; "
        "0 disables",
    )
    mh.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="the process group's rendezvous address, tcp://HOST:PORT "
        "(default: env:// discovery)",
    )
    mh.add_argument(
        "--process-id", type=int, default=None,
        help="this process's rank (default: auto-discover)",
    )
    mh.add_argument(
        "--num-processes", type=int, default=None,
        help="total processes in the fleet (default: auto-discover)",
    )
    mh.add_argument(
        "--cpu-pod-devices", type=int, default=0, metavar="N",
        help="simulate a pod on CPUs: contribute N CPU positions from "
        "this process, collectives over gloo (for testing/dev; 0 = this "
        "process's --device)",
    )
    ap.add_argument(
        "--lease-timeout", type=float, default=30.0,
        help="tpu-push: seconds before a RUNNING task whose owner stopped "
        "renewing its lease (dispatcher AND worker both dead) is adopted "
        "by the rescan",
    )
    ap.add_argument(
        "--shards", default=None, metavar="I,J,...",
        help="sharded store (';'-separated --store url): OWN only these "
        "shard indices — the announce subscription, stranded-task rescans, "
        "and announce replay scope to them, while every shard stays "
        "reachable for writes (cross-shard graph edges, fleet hashes). "
        "Default with a sharded url: own every shard",
    )
    ap.add_argument(
        "--express", action="store_true",
        help="tpu-push: the express result lane — terminal announces "
        "carry bounded inline results (gateways reply from the forward "
        "instead of a store re-read; size via --inline-result-max) and "
        "the serve loop parks its poll on the announce bus, so a submit "
        "wakes intake immediately instead of waiting out --tick-period. "
        "Opt-in: enable once every RESULTS-channel consumer on this "
        "store understands the inline announce form",
    )
    ap.add_argument(
        "--inline-result-max", type=int, default=None, metavar="BYTES",
        help="tpu-push --express: inline up to this many result bytes on "
        "the announce (default 4096); larger results fall back to the "
        "classic id-only announce and the gateway's store read",
    )
    ap.add_argument(
        "--batch-max", type=int, default=0, metavar="K",
        help="push/tpu-push: batched worker data plane — group each "
        "round's assignments into ONE TASK_BATCH frame (up to K tasks) "
        "per batch-capable worker, and accept coalesced RESULT_BATCH "
        "frames back; a K-task bundle then costs O(1) frames and O(1) "
        "worker pool wakeups instead of O(K). Reference-era workers (no "
        "'batch' capability) keep the per-task wire verbatim. 0 (default) "
        "= batching off: the wire is byte-identical everywhere",
    )
    ap.add_argument(
        "--batch-window-ms", type=float, default=0.0, metavar="MS",
        help="tpu-push --express: adaptive micro-batching window for the "
        "announce-woken sub-tick — a small ready set still dispatches "
        "immediately (solo latency unchanged), but under load arrivals "
        "coalesce up to this many ms (or until --batch-max is reached) "
        "so express sub-ticks ship fuller bundles. 0 = every express "
        "wake ticks immediately",
    )
    ap.add_argument(
        "--shared", action="store_true",
        help="several dispatchers share this store+channel: each claims "
        "tasks atomically before dispatching (exactly one runs each "
        "task). Adoption of a DEAD sibling's tasks is done by tpu-push "
        "rescans — include at least one tpu-push dispatcher in a shared "
        "fleet for automatic failover",
    )
    ap.add_argument(
        "--tenant-shares", default=None, metavar="NAME=W,...",
        help="tpu-push: turn on the tenancy plane with this share vector "
        "(e.g. 'team-a=3,team-b=1'; unlisted tenants weigh 1). Placement "
        "becomes weighted-fair INSIDE the device tick: backlogged "
        "tenants are admitted in proportion to their shares, an idle "
        "tenant's capacity spills to the others, and a starved tenant's "
        "deficit boosts it up the priority lane. Hot-reloadable at "
        "runtime via the fleet:tenant_conf store hash (HSET shares "
        "'<spec>:<epoch>'). Pass '' to enable the plane with equal "
        "shares. Single-device feature (refused with --mesh/--multihost)",
    )
    ap.add_argument(
        "--tenant-caps", default=None, metavar="NAME=N,...",
        help="tpu-push: per-tenant inflight ceilings enforced where "
        "placement happens (a tenant at its cap keeps its surplus QUEUED "
        "on device; unlisted = uncapped). Enables the tenancy plane like "
        "--tenant-shares; hot-reloadable via the same store hash",
    )
    ap.add_argument(
        "--max-tenants", type=int, default=32, metavar="N",
        help="tpu-push: tenant-table capacity (a compiled-tick static); "
        "distinct tenant names past it account to the default bucket",
    )
    ap.add_argument(
        "--speculate-mult", type=float, default=None, metavar="M",
        help="tpu-push: turn on the speculation plane (tpu_faas/spec) — "
        "an in-flight execution of a speculative=true task that outlives "
        "M x its predicted runtime is hedged with a replica on a "
        "DIFFERENT worker; the store's first-wins result write decides "
        "the race and the loser is CANCEL-killed. Must be > 1. Single-"
        "device feature (refused with --mesh/--multihost)",
    )
    ap.add_argument(
        "--speculate-max-frac", type=float, default=0.1, metavar="F",
        help="tpu-push: hard wasted-work budget — hedges launched never "
        "exceed F x tasks dispatched (suppressions are counted in "
        "tpu_faas_dispatcher_hedges_total{outcome='suppressed_budget'})",
    )
    ap.add_argument(
        "--columnar", action="store_true",
        help="tpu-push: columnar host data plane — intake decodes store "
        "records straight into a struct-of-arrays task arena "
        "(core/columns.py) and the batch build gathers its device lanes "
        "from columns instead of walking per-task objects; per-task "
        "dicts materialize only at the worker frame boundary. Dispatch "
        "decisions and every wire/store surface are unchanged (property-"
        "pinned); off keeps the classic dict plane byte for byte",
    )
    ap.add_argument(
        "--arena-capacity", type=int, default=None, metavar="N",
        help="tpu-push --columnar: task-arena rows (default 2x "
        "--max-pending); a full arena degrades intake to the dict plane "
        "per task, visible on tpu_faas_columnar_arena_occupancy",
    )
    ap.add_argument(
        "--store-binbatch", action="store_true",
        help="negotiate the RESP binary-batch command surface (CAPS/"
        "MHGETALL/MFINISH) per store connection: batch record fetches "
        "and result finishes ride length-prefixed raw-bytes replies in "
        "ONE round trip. Plain Redis (or an older store) fails the probe "
        "and the classic pipelined commands are used — off the wire is "
        "byte-identical to the default",
    )
    ap.add_argument(
        "--result-blobs", action="store_true",
        help="tpu-push: result data plane — workers with the rblob "
        "capability hash large graph-consumed results and return "
        "digest-only RESULT frames; bodies stay in per-worker result "
        "caches and move worker-to-worker along graph edges "
        "(dep_digests on TASK frames, misses re-filled via reverse "
        "BLOB_MISS pulls from the producer), materializing into the "
        "store only when a legacy reader asks. Implies --dep-results. "
        "Single-device batch-path feature (needs the graph frontier); "
        "off keeps every wire/store surface byte-identical",
    )
    ap.add_argument(
        "--dep-results", action="store_true",
        help="tpu-push: deliver confirmed parents' serialized results on "
        "each graph child's TASK frame (executor.dep_results() in the "
        "pool child). Without --result-blobs the bodies are read from "
        "the store at dispatch — the store-mediated control lane the "
        "result data plane is benched against",
    )
    ap.add_argument(
        "--result-blob-min", type=int, default=None, metavar="B",
        help="tpu-push --result-blobs: only COMPLETED results of at "
        "least B bytes take the digest path (smaller ones ship inline "
        "as always; default core/payload.RESULT_BLOB_MIN_BYTES)",
    )
    ap.add_argument(
        "--speculate-min-s", type=float, default=0.05, metavar="S",
        help="tpu-push: absolute floor — an execution under S seconds is "
        "never flagged however tight its prediction (scheduling jitter "
        "on tiny tasks must not hedge)",
    )
    ap.add_argument(
        "--quarantine", action="store_true",
        help="tpu-push: turn on the quarantine plane (sched/health.py) — "
        "a worker whose health score (decayed by hedge losses, pool-child "
        "misfires and liveness reclaims) falls past the enter threshold "
        "is drained (no new placements; in-flight tasks complete or "
        "reclaim normally), probed with canary tasks, and released when "
        "the score recovers. Hard floors (--quarantine-min-live / "
        "--quarantine-min-capacity) refuse any quarantine that would "
        "strand the fleet. Single-device batch-path feature (refused "
        "with --mesh/--multihost/--resident)",
    )
    ap.add_argument(
        "--quarantine-enter", type=float, default=0.35, metavar="H",
        help="tpu-push --quarantine: quarantine a worker when its health "
        "score drops below H",
    )
    ap.add_argument(
        "--quarantine-release", type=float, default=0.8, metavar="H",
        help="tpu-push --quarantine: release requires the score back "
        "above H for 3 consecutive policy passes",
    )
    ap.add_argument(
        "--quarantine-canary-s", type=float, default=2.0, metavar="S",
        help="tpu-push --quarantine: seconds between canary probes on a "
        "quarantined worker (its placement ceiling opens to 1 task for "
        "one tick)",
    )
    ap.add_argument(
        "--quarantine-min-live", type=int, default=1, metavar="N",
        help="tpu-push --quarantine: hard floor — at least N active "
        "workers stay unquarantined (a quarantine that would cross this "
        "is refused and counted)",
    )
    ap.add_argument(
        "--quarantine-min-capacity", type=float, default=0.5, metavar="F",
        help="tpu-push --quarantine: hard floor — unquarantined workers "
        "retain at least fraction F of registered fleet capacity",
    )
    ns = ap.parse_args(argv)
    if ns.delay:
        time.sleep(ns.delay)

    # shard-slice ownership, resolved ONCE for every mode: build the
    # store handle here so the ShardedStore scopes its consumption
    # surface before any dispatcher constructor subscribes/rescans
    owned_store = None
    if ns.shards is not None:
        from tpu_faas_torch.store.launch import make_store

        owned_store = make_store(
            ns.store,
            owned_shards=[int(x) for x in ns.shards.split(",") if x != ""],
            binbatch=ns.store_binbatch,
        )

    # local, pull and push touch no device and never import torch
    if ns.mode == "local":
        from tpu_faas_torch.dispatch.local import LocalDispatcher

        d = LocalDispatcher(
            num_workers=ns.num_workers,
            store_url=ns.store,
            store=owned_store,
            shared=ns.shared,
        )
        log.info("local dispatcher: pool=%d store=%s", ns.num_workers, ns.store)
        if ns.stats_port:
            d.serve_stats(ns.stats_port)
        _install_stop_signals(d)
        d.start()
        return

    try:
        if ns.mode == "pull":
            from tpu_faas_torch.dispatch.pull import PullDispatcher as cls
        elif ns.mode == "push":
            from tpu_faas_torch.dispatch.push import PushDispatcher as cls
        else:
            if ns.multihost:
                # Validate flag combinations HERE, before any process joins
                # the group: the lead's constructor also rejects these, but
                # by then the followers are blocked in a collective and a
                # lead that exits without serving never sends the stop
                # broadcast
                if ns.mesh:
                    sys.exit("--multihost owns the global mesh; drop --mesh")
                # join the group BEFORE any other device use; followers
                # never reach the dispatcher construction below
                from tpu_faas_torch.parallel import distributed

                cpu_positions = ns.cpu_pod_devices or (
                    1 if ns.device == "cpu" else None)
                distributed.initialize_multihost(
                    coordinator_address=ns.coordinator,
                    num_processes=ns.num_processes,
                    process_id=ns.process_id,
                    cpu_devices_per_process=cpu_positions,
                    backend=ns.dist_backend,
                    timeout=ns.follower_watchdog or None,
                )
                if distributed.process_index() != 0:
                    log.info(
                        "multihost follower %d/%d: positions %s",
                        distributed.process_index(),
                        distributed.process_count(),
                        [str(d) for d in distributed.local_devices(ns.device)],
                    )
                    # shape args mirror the lead's dispatcher kwargs below:
                    # the broadcast layout must agree in every process,
                    # which is why max-slots is a CLI flag rather than a
                    # buried default
                    if ns.resident:
                        from tpu_faas_torch.parallel.multihost_resident import (
                            MultihostResidentScheduler,
                        )

                        follower = MultihostResidentScheduler.from_shape(
                            max_workers=ns.max_fleet,
                            max_pending=ns.max_pending,
                            max_inflight=ns.max_inflight,
                            max_slots=ns.max_slots,
                            time_to_expire=ns.tte,
                            placement=ns.placement,
                            device=ns.device,
                        )
                        if follower.device.type == "cuda":
                            # build B1 before the first packet, as the lead
                            from tpu_faas_torch.sched import fused_tick

                            fused_tick.KERNEL.load()
                    else:
                        from tpu_faas_torch.parallel.multihost_tick import (
                            MultihostTick,
                        )

                        follower = MultihostTick(
                            max_pending=ns.max_pending,
                            max_workers=ns.max_fleet,
                            max_slots=ns.max_slots,
                            placement=ns.placement,
                            device=ns.device,
                        )
                    follower.follow_loop(
                        watchdog_timeout=ns.follower_watchdog or None)
                    # leave the group while the interpreter is whole
                    # (ROADMAP C.7)
                    distributed.shutdown()
                    return
            from tpu_faas_torch.dispatch.tpu_push import (
                TpuPushDispatcher as cls,
            )
    except ImportError as exc:
        sys.exit(f"dispatcher mode {ns.mode!r} is not available: {exc}")

    kwargs = dict(
        ip=ns.ip,
        port=ns.port,
        store_url=ns.store,
        time_to_expire=ns.tte,
        max_task_retries=ns.max_task_retries,
        shared=ns.shared,
    )
    if owned_store is not None:
        kwargs["store"] = owned_store
    if ns.mode == "push":
        kwargs.update(
            heartbeat=ns.hb, process_lb=ns.plb, batch_max=ns.batch_max
        )
    elif ns.mode == "tpu-push":
        kwargs.update(
            rescan_period=ns.rescan,
            tick_period=ns.tick_period,
            max_pending=ns.max_pending,
            max_workers=ns.max_fleet,
            max_inflight=ns.max_inflight,
            max_slots=ns.max_slots,
            placement=ns.placement,
            mesh_devices=ns.mesh or None,
            lease_timeout=ns.lease_timeout,
            multihost=ns.multihost,
            resident=ns.resident,
            tick_backend=ns.tick_backend,
            estimate_runtimes=not ns.no_runtime_learning,
            express=ns.express,
            inline_result_max=ns.inline_result_max,
            batch_max=ns.batch_max,
            batch_window_ms=ns.batch_window_ms,
            tenant_shares=ns.tenant_shares,
            tenant_caps=ns.tenant_caps,
            max_tenants=ns.max_tenants,
            speculate_mult=ns.speculate_mult,
            speculate_max_frac=ns.speculate_max_frac,
            speculate_min_s=ns.speculate_min_s,
            quarantine=ns.quarantine,
            quarantine_enter=ns.quarantine_enter,
            quarantine_release=ns.quarantine_release,
            quarantine_canary_s=ns.quarantine_canary_s,
            quarantine_min_live=ns.quarantine_min_live,
            quarantine_min_capacity=ns.quarantine_min_capacity,
            columnar=ns.columnar,
            arena_capacity=ns.arena_capacity,
            store_binbatch=ns.store_binbatch,
            result_blobs=ns.result_blobs,
            dep_results=ns.dep_results,
            result_blob_min=ns.result_blob_min,
            device=ns.device,
        )
    if ns.mode == "tpu-push" and ns.multihost:
        # Lead-side failure containment: once the followers joined they
        # sit in a blocking collective, and ONLY the serve loop's finally
        # releases them (lead_stop inside start()). Any failure before
        # start() — a busy ZMQ port, a store refusal, a busy stats port —
        # would otherwise exit the lead and strand every follower
        d = None
        serving = False
        try:
            d = cls(**kwargs)
            log.info("%s dispatcher on %s:%d", ns.mode, ns.ip, ns.port)
            if ns.stats_port:
                d.serve_stats(ns.stats_port)
            _install_stop_signals(d)
            serving = True
            d.start()  # its finally broadcasts the follower stop
        except BaseException:
            if not serving:
                try:
                    arrays = getattr(d, "arrays", None)
                    mt = getattr(arrays, "multihost", None)
                    if mt is None and hasattr(arrays, "lead_stop"):
                        mt = arrays  # resident+multihost: arrays is the lead
                    if mt is None and ns.resident:
                        from tpu_faas_torch.parallel.multihost_resident import (
                            MultihostResidentScheduler,
                        )

                        mt = MultihostResidentScheduler.from_shape(
                            max_workers=ns.max_fleet,
                            max_pending=ns.max_pending,
                            max_inflight=ns.max_inflight,
                            max_slots=ns.max_slots,
                            time_to_expire=ns.tte,
                            placement=ns.placement,
                            device=ns.device,
                        )
                    if mt is None:
                        from tpu_faas_torch.parallel.multihost_tick import (
                            MultihostTick,
                        )

                        mt = MultihostTick(
                            max_pending=ns.max_pending,
                            max_workers=ns.max_fleet,
                            max_slots=ns.max_slots,
                            placement=ns.placement,
                            device=ns.device,
                        )
                    mt.lead_stop()
                    log.info("released multihost followers before exiting")
                except Exception:
                    log.exception(
                        "could not release multihost followers — they must "
                        "be killed manually"
                    )
            raise
        # the followers are released: leave the group while the
        # interpreter is whole (ROADMAP C.7)
        distributed.shutdown()
        return

    d = cls(**kwargs)
    log.info("%s dispatcher on %s:%d", ns.mode, ns.ip, ns.port)
    if ns.stats_port:
        d.serve_stats(ns.stats_port)
    _install_stop_signals(d)
    d.start()


if __name__ == "__main__":
    main()
