"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py      # every phase, at the headline shape

Phases, all run every time (each fails the run; nothing is caught and passed
over):

0. ``build``  — print the card's name and power limit, the torch and CUDA
   versions; build the libraries from ``tpu_faas_torch/csrc`` with nvcc for
   sm_90a, one nvcc per build, started together: the fused tick (B1, rank,
   auction and Sinkhorn branches), its probe build (``-DTPU_FAAS_PROBE``:
   each branch stamps block 0's clock at its phases) and the top-2 bid
   (B2); print each kernel's registers and shared memory.
1. ``kernel`` — the fused tick's rank branch against its plain PyTorch
   version on the card, at 51,200 pending x 4,096 workers x 65,536
   in-flight slots, priority admission on and off, several seeds: every
   output and every state leaf must be exactly equal. Then its edge
   states (``edge_case``), exactly equal too: a cold tick with every slot
   free, a priority threshold inside a tie of thousands, no valid slot,
   and -inf and NaN speeds on a live row with free slots and sizes on an
   admitted task, which alone must take the branch's full-length path (a
   count in its scratch); the cold tick is timed.
2. ``resident`` — the resident scheduler end to end at that shape: 4,096
   workers, 51,200 bulk-loaded tasks, then per tick 512 results, 128
   heartbeats and 512 arrivals with the clock advanced 5 ms, resolved in tick
   order two ticks deep; partway through 64 workers go silent past
   time_to_expire. Checks one kernel launch per steady tick, no host sync
   inside ``tick_resident`` (``torch.cuda.set_sync_debug_mode("error")``),
   state tensors that never move, no task over-booked, placed twice or lost,
   every in-flight slot of a purged worker redispatched, and every launch's
   outputs and state equal to the plain version's from the same state.
   Logs how many of the loop's rank ticks took the full-length path.
3. ``sim``    — ``SimFleet`` on the card: 4,096 workers x 4 processes, 5%
   churn per tick, 20,000 tasks; every task completes, none lost.
4. ``bid``    — kernel B2 against its plain version on the card, exactly
   equal on v1, best and v2: at bench config 7's headline bid (51,200 x
   32,768), at BASELINE config 3's shape (10,240 x 4,096), ragged, with no
   valid slot and one, with a max duplicated across lanes at zero jitter,
   with a hash index past 2^32 (row_offset, n_slots_total), and with
   ROADMAP C.3's NaN sizes, speed, prices and jitter and an inf - inf cell
   (4,096 x 32,768; a NaN equal to a NaN in the same place).
5. ``auction`` — ``SchedulerArrays(placement="auction")`` on the card, the
   batch auction tick with the price carry: config 3's uniform and
   lognormal legs (10,000 tasks, 1,000 workers x 4) over 4 ticks each, and
   3 ticks at the headline shape (51,200 pending, 4,096 workers x 8). Every
   tick's assignment is legal and complete, takes one B2 launch per
   bidding round, and equals a twin tick whose bids are the plain version,
   on assignment, rounds, prices, refresh and spilled count.
6. ``resident_auction`` — B1's auction branch: first against its plain
   version on synthetic headline states (refresh on and off, priority lanes
   on and off, two seeds; seed 0 also against the plain version with plain
   bids; a warm tick with 13 bidders and a cold tick in which every task
   bids; C.3's NaN sizes, cold and warm, NaN speeds and NaN carried
   prices), every output and state leaf exactly equal, prices, refresh,
   round and spilled counts included; then ``ResidentScheduler(placement=
   "auction")`` through phase 2's loop for 40 ticks (FCFS), with phase 2's
   checks, one cooperative launch per steady tick, and at least one cold
   (refresh) and one warm tick. The kernel also reports the bidder rows
   summed over its rounds, equal to the plain version's count. Then the
   round split: the probe build on the 13-bidder and every-bidder ticks and
   on the loop's last 5 states (each launch equal to the kernel proper's),
   block 0's clock at the opening, the seed or rebase, each round's bids
   (until the last block is done), their barrier, the install pass and the
   bidder collection with theirs, and the close.
7. ``resident_sinkhorn`` — B1's Sinkhorn branch: the kernel's ``expf`` and
   ``logf`` bit for bit against ``torch.exp``/``torch.log``; the branch
   against its plain version on synthetic headline states (bucketed route,
   priority lanes on and off, two seeds; one with -inf sizes and speeds,
   whose spill must take rank placement's own sorts) and on one
   dense-route state at 4,096 x 4,096, under the contract: (a) exact on
   every output and state leaf that placement does not decide, the count
   placed and the effective temperature; (b) final potentials within SINKHORN_TOL of tau; (c) the
   plain rounding from the kernel's own potentials equal to the kernel's
   tick on every output and leaf; (d) no row over-booked, no task placed
   twice, placed = min(KP, valid, capacity). Ticks placed otherwise than
   the plain version's own potentials are counted, not failed. Then
   ``ResidentScheduler(placement="sinkhorn")`` through phase 2's loop for 50
   ticks (FCFS) with phase 2's checks, every launch held to the contract
   from its pre-state; and ``SchedulerArrays(placement="sinkhorn")`` at
   BASELINE config 4, beside config 4's own solve, against the LP makespan
   bound.
8. ``resident_tenancy`` — B1's tenancy lane (``NT`` = 32 tenant rows, the
   dispatcher's default) in its three branches: against the plain version on
   synthetic headline states (tenant rows past both ends of [0, NT) in the
   state and the arrival lane, deficits around the starvation threshold and
   at the cap, caps of 0, at ``ahead``, below and above it; priority lanes
   off and on), rank and auction ticks and the flush exactly equal on every
   output and state leaf (``t_deficit`` and the eligibility included; one
   auction state also against plain bids), Sinkhorn under its contract with
   the eligibility added to (a); each branch timed with the lane off and
   on, on the same state. Then a resident loop per branch (phase 2's loop
   and checks, shortened: 60 rank, 16 auction and 20 Sinkhorn ticks) with
   config 16's shares and caps (light=8, heavy=1, heavy capped at the
   fleet's slots minus one) and four more capped tenants, arrivals tagged
   across all 32 rows, the table's inflight counts kept as the dispatcher
   keeps them; every launch holds each tenant within its allowance. A rank
   and an auction tick with 4,096 tenant rows (past the 1,024 whose counts
   block 0 keeps in shared memory) are exactly equal too, and a rank tick
   at 1,100 rows with priorities. Last, the rank branch with the lane on
   the rank loop's own states, beside its plain version and its bound,
   and its split by the probe build.
9. ``resident_spec`` — B1's speculation lane (config 18's knobs: straggler
   multiplier 3, floor 0.02 s) in its three branches: against the plain
   version on synthetic headline states with the tenancy lane off and on
   (in-flight slots past, at and under their threshold, on dead rows, with
   pred <= 0 and NaN; packet pred and avoid lanes with clears and wrapped
   negative indices; the avoid rows of more than 64 tasks on the rows
   placement gives them, so the veto fires and the fixup's bound binds;
   over-cap free counts), rank and auction ticks and the flush exactly
   equal on every output and state leaf (the straggler slots and the
   ``infl_start``/``infl_pred``/``avoid`` leaves included), Sinkhorn under
   its contract with the fixup added to (c) and (d); each branch timed with
   the lane off and on, on the same state. Then a resident loop per branch
   (phase 2's loop and checks: 60 rank ticks with priority, 16 auction, 20
   Sinkhorn, and 25 rank ticks with the tenancy lane too) in which 64 live
   workers never return results, so their slots flag; each tick re-submits
   the newly flagged slots (at most KG) as hedges avoiding the original's
   row, as the dispatcher does; no hedge lands on its avoid row. Last, the
   rank branch with the lane on the rank loop's own states, beside its
   plain version and its bound, and its split by the probe build.
10. ``time``  — CUDA-event medians of B1's rank branch (on the resident run's
   own states and packets, and on a synthetic state), the probe build's
   split of the rank branch on the same states (block 0's clock at the end
   of each phase: packet, liveness, lists, tenancy, select, admission,
   sorts, pairing, fixup, deficit, compaction; the valid slots, admitted
   tasks, select passes and full-length ticks), and of B2 (at both bid
   shapes), and CUDA-event means of B1's auction branch over the resident
   auction run's own states (its warm and cold ticks differ forty-fold in
   bidders; each kind's medians are printed too), and of their plain
   versions, each beside its bound (the auction's counts the cells its
   bidders swept); the auction's plain version bids with the plain top-2,
   and each of its ticks is held exactly against the kernel's; the bids'
   bound counts each cell's instructions per issue pipe, read from the
   compiled loop, at the card's clock; CUDA-event
   means of B1's Sinkhorn branch and its plain version over the resident
   Sinkhorn run's states, with a launch's split by block 0's clock, a grid
   barrier timed alone, the probe build's split of each state (f-updates,
   g-updates and their barriers, the close's sorts and spill, candidates
   and spilled tasks), the bound per pipe (one exp a cell on the SFU
   against 5 issue slots) and the iterations' library yardstick (40
   torch.logsumexp calls over the materialized matrix, context only); host-clock medians of the integrated
   ``tick_resident`` (rank, auction and Sinkhorn), of the batch tick and of
   the auction tick cold and warm, all printed beside the card's name and
   power limit. Each timed launch is queued behind a spin kernel, so its
   events measure device time and not the host's launch gap.
11. ``graph`` — the graph frontier on the batch tick (run after phase 9)
   at the headline shape: 51,200 pending rows as 5,120 of config 13's
   diamonds (one root, 8 middles, one sink; 81,920 edges padded to
   131,072) held in the port's ``GraphFrontier``, about half the parents
   confirmed with the worker row that ran them and a result digest two
   rows hold; 4,096 workers of 1-8 slots in four equal-speed classes, 64
   of them silent with tasks in flight. ``SchedulerArrays.tick`` with
   ``dep_edges``, ``task_pref`` and ``pref_edges``: rank exactly equal to
   the port's CPU run of the same inputs on every output; auction (B2
   launched, counted from 0) and Sinkhorn with no row with an unconfirmed
   parent placed, no worker past min(free, K), and against the same tick
   without preferences every changed task one of a swap between
   equal-speed workers (that tick also equal to the exchange's input).
   Prints each placement's batch tick time with the lanes on and off (CUDA
   events).
12. ``profile`` — the headline rank loop (phase 2's, 24 checked
   ticks) with its 20 timed ticks captured by the port's ``TickProfiler``
   on ``torch.profiler`` into ``tick_profile/`` (git-ignored), each
   captured tick holding the B1 launches the wrapper counted in it;
   prints B1's mean kernel time, the mean device idle between one tick's
   last device operation and the next tick's first, its split inside a
   tick (host work before the packet copy, the device's wait from the
   copy to B1, host work after B1), and the card's busy share of the
   captured window. Then phase 11's batch ticks again, lanes off and on,
   each captured: a tick's card time as the union of the device
   operations it issued (the auction's and Sinkhorn's host syncs drop out
   of it).
13. ``dispatcher`` — the port's tpu-push dispatcher
   (``tpu_faas_torch.dispatch.tpu_push.TpuPushDispatcher``, resident rank
   placement, B1 on every tick), run before the profile phase. Leg 1, serve:
   the dispatcher at its default shape (4,096 workers, 8,192 pending,
   65,536 in flight, 8 slots) on its own thread, its store the port's
   in-process store server wrapped in the port's ``RaceCheckStore``; 16
   wire workers in threads of this script (DEALER sockets speaking the
   port's ``worker.messages``: REGISTER with 8 processes, HEARTBEAT,
   RESULT; payloads run through the port's executor); 512 requests of a
   small function written and announced as the gateway writes them, one
   worker silenced halfway so that B1's liveness, purge and redispatch act.
   Every request comes back COMPLETED with its value, the race monitor
   finds no violation, B1 was launched; prints the throughput, the median
   and p99 submit-to-result latency (to the announce of the terminal
   record on the results channel), B1 launches per tick and the
   dispatcher's own split of a request by its trace stages. Leg 2, host
   dispatch: config_9_host_dispatch's recipe at its default shape (20,000
   tasks, 4,096 workers registered as ROUTER mirrors x 8 processes, every
   announce drained off the bus into the dispatcher's backlog before the
   clock starts, in batches of 1,000) on the resident rank path:
   ``tasks_per_s`` from one pass whose every B1 launch is then replayed
   through the plain version (outputs and state, exactly) and no row holds
   more tasks than its processes; then a pass on fresh tasks captured by
   the port's ``TickProfiler``, each tick holding the B1 launches the
   wrapper counted: B1's time a launch, the card's busy share, the device
   idle inside a tick and between ticks.
14. ``host`` — imports every module of the port (none of JAX or the JAX
   package may load), starts the port's store server in process, writes
   and reads back 300 task records through the port's ``RespStore`` and
   300 through its ``MemoryStore``, and encodes and decodes a TASK message
   in both framings; prints the counts.
15. ``mesh`` — multi-device scheduling (``tpu_faas_torch/parallel``), run
   after the profile phase, at the headline shape. (a) One process, 4
   positions named explicitly on the one card (``make_mesh(devices=...)``;
   positions, not cards): ``sharded_scheduler_tick`` under rank (with
   priorities), the auction through both winner routes (``gspmd``: the
   single-device solver on the gathered tasks; ``permute``: each run of
   positions on one device bids its rows as one block with B2, the ring
   resolves the winners across runs; run again with each position a run
   of its own, the layout of positions that each have a card: B2 at each
   position's row offset, the ring across the four) and Sinkhorn (the
   sharded dense iterations, one scripted call a tick), each against the
   single-device tick on the same inputs: rank and the auction routes
   equal on every output, prices and rounds included, B2 launched once a
   round (gspmd), once a run a round (permute: the four positions share
   the card, one run) or four times a round (runs of one); Sinkhorn the
   same count placed at a cost within 5% (JAX's pin),
   no row over-booked; each tick's torch calls from Python counted.
   (a') The single-device rank batch tick (one scripted call) against
   ``scheduler_tick_impl`` run eagerly, FCFS and with priorities: every
   output equal, both timed in turns.
   (b) ``mesh_devices=1`` on cuda: ``SchedulerArrays`` and
   ``ResidentScheduler`` through 40 ticks of
   a churn loop (256 results and arrivals a tick, 64 workers silenced at
   tick 25) in lockstep with the same loop without a mesh: every output
   and resolved tick equal, the resident states equal, one B1 launch a
   steady tick. At N=1 the resident leg runs the same code as without a
   mesh: it checks the construction only. (c) Two processes on the one
   card, gloo through host memory (two processes sharing one card, not a
   number for two cards): 20 ticks of ``MultihostTick`` (rank) and 20 of
   ``MultihostResidentScheduler`` (rank), each a lead with its follower,
   at an odd ``max_pending`` that the 2-position mesh pads by one; both
   ranks bit for bit, the lead equal to the single-process tick and
   scheduler at the padded shape, the broadcast's bytes and milliseconds
   a tick logged; then 2 Sinkhorn ticks of ``MultihostTick``, one
   position a process (the scripted tick's collectives through gloo):
   both ranks bit for bit, the lead's held to the single-device tick as
   in (a). (d)
   ``python -m tpu_faas_torch.dispatch -m tpu-push`` in each layout with
   a store server of the port's each, all started at once and served in
   turn: ``--resident --multihost`` and ``--multihost`` as a lead and a
   follower on the card (``--dist-backend gloo``), ``--mesh 1`` and
   ``--mesh 1 --resident``; 64 requests of ``smoke_fn``
   (16 in the other layouts) in bursts of 16 (ROADMAP C.5) through 4 wire
   workers, each answered once; the lead's SIGTERM releases the follower
   and every process exits 0. Last, ``--mesh 4`` on a machine with fewer
   than 4 cards exits at startup with the device-count message.
16. ``stack`` — the system as separate processes through the port's entry
   points, run after the dispatcher phase: ``python -m
   tpu_faas_torch.store.server``, ``python -m tpu_faas_torch.gateway``,
   then in turn each dispatcher ``python -m tpu_faas_torch.dispatch``
   with its workers: ``-m tpu-push --resident --device cuda`` (the CLI's
   default shape) with 4 ``push_worker 4 --hb`` serving 1,000 calls made
   with the port's ``FaaSClient.map`` over REST, one worker SIGKILLed
   (with its pool) once half the results are announced; ``-m local -w
   4``, ``-m pull`` with 2 ``pull_worker 4`` and ``-m push --hb`` with 4
   ``push_worker 4 --hb`` (one killed halfway), 256 calls each. Every
   call comes back COMPLETED with its value, each task announced on the
   results channel once, no child but the killed one exits, and every
   child is reaped. From the tpu-push dispatcher's ``/stats`` its
   ``tick_backend`` (``fused_cuda``: B1 on the card) and from its
   ``/metrics`` its resident ticks and B1 launches. Prints each leg's
   calls served a second, the median and p99 submit-to-result latency
   (the gateway's submit stamp to the terminal write's), beside the
   card's name and power limit; the children's logs go to
   ``chiprun_out/stack/``.
16b. ``planes`` — the tpu-push dispatcher's opt-in planes through the same
   entry points, run after the stack phase and before the profile phase
   (one store server and gateway; every dispatcher ``-m tpu-push
   --resident --device cuda``). (a) ``--express --batch-max 16
   --batch-window-ms 2`` with 4 ``push_worker 4 --hb``: 1,000 calls of
   3x + 1 in batches of 100, each collected with ``FaaSClient.wait_many``
   before the next is submitted; every call answered once with its value,
   the gateway's inline deliveries and the dispatcher's TASK_BATCH frames
   above 0. (b) 2
   ``push_worker 2 --hb``: a backlog of 200 priority-0 sleeps of 100 ms,
   then 20 priority-9 ones; each priority-9 call starts before every
   priority-0 call still queued when it was submitted (the record's
   submit stamp; ``test_priority.py``'s ordering). (c) on (b)'s
   dispatcher: 10 queued calls cancelled and 2 running ones
   force-cancelled (CANCELLED), 5 calls with a timeout hint shorter than
   their sleep (FAILED, ``TaskTimeout``), one call that kills its pool
   child (FAILED), every other call COMPLETED; in (b) and (c) each call's
   result announced once. (d) two ``--shared``
   dispatchers on one store and the one card, each with 2 ``push_worker
   2 --hb``: 400 calls, one dispatcher SIGKILLed with its fleet once half
   are announced; every call COMPLETED and announced once, both
   dispatchers placed calls. In (a), (b) and (d) every dispatcher's B1
   launches equal its resident ticks (its ``/metrics``, read between
   ticks) and ``tick_backend`` is ``fused_cuda``. Prints each leg's calls,
   served/s, median and p99 submit-to-result (store stamps), B1 launches
   and ticks, inline deliveries and TASK_BATCH frames beside the card's
   name and power limit; the children's logs go to ``chiprun_out/planes/``.
17. ``analysis`` — run right after the build: the port's static analysers
   (``python -m tpu_faas_torch.analysis``) over this checkout's
   ``tpu_faas_torch/`` in a fresh interpreter, which must exit 0 with no
   finding of either severity and load no torch, JAX or JAX package
   module; prints the checker count, the file count and the inventory of
   ``trace.host-sync`` suppressions (the host syncs on the card's path, by
   site). Then the bindings against the libraries the build phase built:
   every symbol the wrappers bind (as ``kernelparity`` reads them from
   ``sched/fused_tick.py`` and ``sched/bid.py``) exists in its library,
   and each bound function object's ``argtypes`` is as long as the
   ``extern "C"`` parameter list parsed from its ``.cu`` source. Prints
   the phase's seconds beside the card's name and power limit.
18. ``bench`` — run after the mesh phase, before the host phase: the
   port's bench (``tpu_faas_torch/bench/``) through its CLI, ``python -m
   tpu_faas_torch.bench --config N`` on the card, one process a config,
   at each config's own shapes: config 4 (Sinkhorn, 50,000 x 4,000 padded
   to 51,200 x 4,096; makespan over the LP bound at most 1.05), 7 (B2 and
   its plain version at 51,200 x 32,768), 15 (the fused and plain
   resident ticks at 50,000 x 4,096 and 200,000 x 16,384, every timed
   tick one dispatch; one B1 rank tick at 500,000 x 32,768 and one B1
   auction tick at 50,000 x 4,096) and 1 (BASELINE's push sleep: 8 push
   workers x 4, 80 sleeps of 0.1 s, 3 runs, every result right). Any
   ``error`` or ``*_error`` field, a non-zero exit or a line not
   labelled with the card fails the run. Then B1's rank branch at config
   15's larger shapes (``BENCH_B1_SHAPES``, the config's own recipe),
   every launch exactly equal to its plain version. Prints each line, its
   numbers and the phase's seconds; children's stderr in
   ``chiprun_out/bench/``.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel's launches on its main path (the resident run for B1's
rank branch, the auction ticks for B2, the resident auction run for B1's
auction branch, the resident Sinkhorn run for its Sinkhorn branch, and the
resident tenancy rank run for its tenancy lane, and the resident
speculation rank run for its speculation lane), errors and times; B1's
rank entry also carries ``dispatcher_launches``, its launches in the
dispatcher phase's serve leg and host-dispatch pass, each counted from 0,
and ``mesh_launches``, its launches in the mesh phase's (b) resident loop
(``mesh_devices=1``) and in (c)'s lead and follower (the padded shape); B2's entry carries
``mesh_launches`` too, its launches in (a)'s gspmd and permute auctions.
B1's rank entry also carries ``stack_launches`` and ``stack_ticks``, the
stack phase's tpu-push dispatcher's B1 launches and resident ticks, and
``planes_launches`` and ``planes_ticks``, the planes phase's dispatchers'
(legs (a), (b)-(c), and (d)'s killed and surviving ones). B1's rank
entry and B2's carry ``bench_launches``: the bench phase's config 15 and
config 7 processes' launches (from their lines), and for B1 also the
launches of that phase's checks at config 15's larger shapes.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
#: the headline shape (bench.py) and the resident scheduler's packet sizes
SHAPE = dict(T=51_200, W=4_096, I=65_536, KA=512, KH=512, KF=1024, KI=1024,
             KS=512, KB=256, KP=2048, KR=512)
MAX_SLOTS = 8
N_TICKS = 200  # checked resident ticks
N_TIMED = 60  # timed ticks and launches per timing
N_AUCTION_TICKS = 30  # checked resident auction ticks
N_AUCTION_TIMED = 10  # timed resident auction ticks
#: spin queued ahead of each timed launch (about 10 ms at 1.98 GHz), so the
#: host has enqueued the launch before the card reaches its start event
SPIN_CYCLES = 20_000_000
#: the tenancy lane: the dispatcher's default max_tenants
#: (tpu_faas/dispatch/tpu_push.py:104), and the statics that turn it on
NT_HEADLINE = 32
TENANCY_KW = dict(use_tenancy=True, NT=NT_HEADLINE)
#: tenant rows past the 1,024 whose counts block 0 keeps in shared memory
#: (ROADMAP C.2's cases)
NT_MID, NT_WIDE = 1100, 4096
#: the resident loops' arrival mix over the 32 rows: default, light, heavy,
#: then the 29 other tenants evenly
TENANT_MIX = np.array([0.05, 0.15, 0.6] + [0.2 / 29] * 29)
#: (checked, timed) resident ticks with the tenancy lane, per branch
TENANCY_TICKS = {"rank": (40, 20), "auction": (12, 4), "sinkhorn": (15, 5)}
#: the speculation lane: config 18's knobs (tpu_faas/bench/configs.py:3169),
#: the scheduler's straggler output, the prediction stamped on every
#: dispatch (seconds; flagged past 3 x 0.02 s = 12 ticks of 5 ms) and the
#: live workers that never return a result
SPEC_MULT, SPEC_MIN_S, KG = 3.0, 0.02, 64
SPEC_KW = dict(use_spec=True, KG=KG)
SPEC_PRED = 0.02
N_STUCK = 64
#: (checked, timed) resident ticks with the speculation lane, per loop
SPEC_TICKS = {"rank": (40, 20), "auction": (12, 4), "sinkhorn": (15, 5),
              "rank+tenancy": (20, 5)}


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 1: kernel against its plain version --------------------------------
def random_case(rng: np.random.Generator, use_priority: bool, now: float,
                shape: dict = SHAPE):
    """A resident state and one full delta packet with ties, zero (and
    negative-zero) sizes, dead and silent workers, never-heard rows,
    negative and over-cap free counts, an over-KP backlog and negative free
    deltas, at ``shape`` (the headline by default)."""
    T, W, I = shape["T"], shape["W"], shape["I"]
    f32 = np.float32

    def tied_sizes(n):
        s = rng.uniform(0.1, 10.0, n).astype(f32)
        tie = rng.random(n) < 0.3
        s[tie] = np.round(s[tie] * 2) / 2
        s[rng.random(n) < 0.05] = 0.0
        s[rng.random(n) < 0.02] = -0.0
        return s

    speed = (np.round(rng.uniform(0.5, 4.0, W) * 4) / 4).astype(f32)
    speed[rng.random(W) < 0.02] = 0.0
    last_hb = (now - rng.uniform(0.0, 12.0, W)).astype(f32)
    last_hb[rng.random(W) < 0.02] = -np.inf
    leaves = dict(
        sizes=tied_sizes(T),
        valid=rng.random(T) < 0.6,
        prio=rng.integers(-3, 4, T).astype(np.int32),
        tenant=np.zeros(T, np.int32),
        last_hb=last_hb,
        free=rng.integers(-1, 10, W).astype(np.int32),
        inflight=np.where(rng.random(I) < 0.5, -1,
                          rng.integers(0, W, I)).astype(np.int32),
        prev_live=rng.random(W) < 0.9,
        speed=speed,
        active=rng.random(W) < 0.95,
        price=np.zeros(W * MAX_SLOTS, f32),
        t_deficit=np.zeros(1, f32),
        infl_start=np.zeros(1, f32),
        infl_pred=np.zeros(1, f32),
        avoid=np.full(1, -1, np.int32),
        refresh=np.asarray(True),
    )
    S = shape
    lanes = 2 if use_priority else 1
    P = 9 + S["KA"] * lanes + 2 * (S["KH"] + S["KF"] + S["KI"] + S["KS"]
                                   + S["KB"])
    p = np.zeros(P, f32)
    counts = [int(rng.integers(K // 2, K + 1))
              for K in (S["KA"], S["KH"], S["KF"], S["KI"], S["KS"], S["KB"])]
    p[0] = now
    p[1:7] = counts
    p[8] = 10.0  # time_to_expire
    off = 9
    n_arr, n_hb, n_fr, n_if, n_sp, n_ac = counts
    p[off : off + n_arr] = tied_sizes(n_arr)
    off += S["KA"]
    if use_priority:
        p[off : off + n_arr] = rng.integers(-3, 4, n_arr)
        off += S["KA"]
    for n, K, N, vals in (
        (n_hb, S["KH"], W, lambda n: now - rng.uniform(0.0, 12.0, n)),
        (n_fr, S["KF"], W, lambda n: rng.integers(-2, 3, n)),
        (n_if, S["KI"], I, lambda n: rng.integers(-1, W, n)),
        (n_sp, S["KS"], W, lambda n: np.round(rng.uniform(0.5, 4, n) * 4) / 4),
        (n_ac, S["KB"], W, lambda n: (rng.random(n) < 0.9).astype(f32)),
    ):
        p[off : off + n] = rng.choice(N, n, replace=False)
        off += K
        p[off : off + n] = vals(n)
        off += K
    return leaves, p


def clone_state(st):
    return type(st)(*(t.clone() for t in st))


def same(x: torch.Tensor, y: torch.Tensor) -> bool:
    """torch.equal, with a NaN equal to a NaN in the same place (the
    speculation lane carries NaN predictions as values)."""
    if torch.equal(x, y):
        return True
    if not x.is_floating_point() or x.shape != y.shape:
        return False
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(x[~nx], y[~ny])


#: outputs the kernel alone reports (the plain version has None there)
KERNEL_ONLY = ("auction_full_length",)


def compare(a, b, what: str) -> tuple[int, float]:
    """(mismatched fields, max abs error) between two tuples of tensors; a
    field of KERNEL_ONLY is compared only where both report it."""
    bad, err = 0, 0.0
    for name, x, y in zip(a._fields, a, b):
        if (x is None and y is None) or (name in KERNEL_ONLY
                                         and (x is None or y is None)):
            continue
        if x.shape != y.shape or x.dtype != y.dtype or not same(x, y):
            bad += 1
            if x.shape == y.shape:
                d = (x.double() - y.double()).abs()
                d = d[torch.isfinite(d)]
                err = max(err, float(d.max()) if d.numel() else float("inf"))
            else:
                err = float("inf")
            log(f"  MISMATCH {what}.{name}: {x.dtype}{list(x.shape)} vs "
                f"{y.dtype}{list(y.shape)}")
    return bad, err


def phase_kernel(dev) -> dict:
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl, state_from_numpy,
    )

    S = SHAPE
    mismatches, max_err, cases = 0, 0.0, 0
    for use_priority in (False, True):
        for seed in (0, 1, 2):
            rng = np.random.default_rng(seed)
            leaves, pkt = random_case(rng, use_priority, now=100.0)
            st_k = state_from_numpy(leaves, dev)
            st_p = clone_state(st_k)
            packet = torch.from_numpy(pkt).to(dev)
            kw = dict(S, max_slots=MAX_SLOTS, use_priority=use_priority)
            res_p, new_p = _resident_tick_impl(packet, st_p, **kw)
            ptrs = [t.data_ptr() for t in st_k]
            res_k, new_k = KERNEL(packet, st_k, flush=False, **kw)
            torch.cuda.synchronize()
            assert [t.data_ptr() for t in new_k] == ptrs, "state moved"
            b1, e1 = compare(res_k, res_p, "out")
            b2, e2 = compare(new_k, new_p, "state")
            n_placed = int((res_k.placed_slots >= 0).sum())
            log(f"  prio={use_priority} seed={seed}: placed {n_placed}/"
                f"{S['KP']} (KP), n_pending {int(res_k.n_pending)}, "
                f"redispatch {int((res_k.redispatch_slots >= 0).sum())}, "
                f"purged {int(res_k.purged.sum())}, mismatched fields "
                f"{b1 + b2}")
            mismatches += b1 + b2
            max_err = max(max_err, e1, e2)
            cases += 1
        # the flush mode (delta application alone) on a fresh case
        leaves, pkt = random_case(np.random.default_rng(9), use_priority,
                                  now=100.0)
        st_k = state_from_numpy(leaves, dev)
        packet = torch.from_numpy(pkt).to(dev)
        kw = {k: v for k, v in S.items() if k not in ("KP", "KR")}
        new_p, arr_p = _flush_kernel_impl(packet, clone_state(st_k),
                                          use_priority=use_priority, **kw)
        new_k, arr_k = KERNEL(packet, st_k, flush=True, KP=S["KP"],
                              KR=S["KR"], max_slots=MAX_SLOTS,
                              use_priority=use_priority, **kw)
        torch.cuda.synchronize()
        b, e = compare(new_k, new_p, "flush-state")
        if not torch.equal(arr_k, arr_p):
            b += 1
            log("  MISMATCH flush arrival_slots")
        log(f"  prio={use_priority} flush: mismatched fields {b}")
        mismatches += b
        max_err = max(max_err, e)
    if mismatches:
        raise SystemExit(f"kernel disagrees with its plain version: "
                         f"{mismatches} mismatched fields")
    log(f"phase kernel: {cases} ticks + 2 flushes exactly equal")
    return {"mismatches": mismatches, "max_abs_err": max_err}


#: the rank branch's edge states (``edge_case``); the fallback ones take
#: its full-length path
RANK_EDGES = ("cold", "tie", "no_slots", "inf_speed", "nan_speed",
              "inf_size", "nan_size")
RANK_FALLBACKS = ("inf_speed", "nan_speed", "inf_size", "nan_size")


def edge_case(kind: str, use_priority: bool):
    """``random_case``'s state and packet (seed 30) made into one of the
    rank branch's edge states. ``cold``: every slot free (every row live
    with free counts past K) under 95% valid tasks, more than the slots;
    ``tie``: priorities 0 on nine tasks in ten and 5 on the rest, so the
    admission's threshold falls inside a tie of thousands; ``no_slots``:
    every row inactive; ``inf_speed``/``nan_speed``: a live row with free
    slots whose speed is -inf/NaN; ``inf_size``/``nan_size``: task 0,
    valid and first in the admission, of size -inf/NaN. Each but ``tie``
    and ``no_slots`` drops the packet's heartbeat, free, speed and active
    scatters, which would change the rows it set."""
    leaves, pkt = random_case(np.random.default_rng(30), use_priority,
                              now=100.0)
    T, W = SHAPE["T"], SHAPE["W"]
    leaves = {k: np.array(v) for k, v in leaves.items()}
    rng = np.random.default_rng(31)
    if kind not in ("tie", "no_slots"):
        pkt[[2, 3, 5, 6]] = 0
    if kind == "cold":
        leaves["valid"] = rng.random(T) < 0.95
        leaves["free"][:] = MAX_SLOTS + 2
        leaves["active"][:] = True
        leaves["last_hb"][:] = 100.0
    elif kind == "tie":
        leaves["valid"] = rng.random(T) < 0.95
        leaves["prio"] = np.where(rng.random(T) < 0.1, 5, 0).astype(np.int32)
    elif kind == "no_slots":
        leaves["active"][:] = False
        pkt[6] = 0
    elif kind in ("inf_speed", "nan_speed"):
        leaves["active"][0] = True
        leaves["last_hb"][0] = 100.0
        leaves["free"][0] = MAX_SLOTS
        leaves["speed"][0] = -np.inf if kind == "inf_speed" else np.nan
    elif kind in ("inf_size", "nan_size"):
        leaves["valid"][0] = True
        leaves["prio"][0] = 100
        leaves["sizes"][0] = -np.inf if kind == "inf_size" else np.nan
    return leaves, pkt


def rank_edges(dev) -> dict:
    """The rank branch on ``edge_case``'s states, priority lanes off and on
    (``tie`` with priorities alone): every output and state leaf exactly
    equal to the plain version's, and the fallback states, and they alone,
    counted on the full-length path. Then the cold state timed, kernel and
    plain version, with priority."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _resident_tick_impl, state_from_numpy,
    )

    S = SHAPE
    bad, err, cases = 0, 0.0, 0
    for kind in RANK_EDGES:
        for use_priority in ((True,) if kind == "tie" else (False, True)):
            leaves, pkt = edge_case(kind, use_priority)
            packet = torch.from_numpy(pkt).to(dev)
            kw = dict(S, max_slots=MAX_SLOTS, use_priority=use_priority)
            res_p, new_p = _resident_tick_impl(
                packet, state_from_numpy(leaves, dev), **kw)
            before = KERNEL.rank_fallbacks(dev, S["T"], S["W"], MAX_SLOTS)
            res_k, new_k = KERNEL(packet, state_from_numpy(leaves, dev),
                                  flush=False, **kw)
            took = KERNEL.rank_fallbacks(dev, S["T"], S["W"],
                                         MAX_SLOTS) - before
            b1, e1 = compare(res_k, res_p, f"{kind} out")
            b2, e2 = compare(new_k, new_p, f"{kind} state")
            want = int(kind in RANK_FALLBACKS)
            if took != want:
                b1 += 1
                log(f"  MISMATCH {kind}: full-length path taken {took} "
                    f"times, expected {want}")
            log(f"  {kind} prio={use_priority}: placed "
                f"{int((res_k.placed_slots >= 0).sum())}/{S['KP']} (KP), "
                f"n_pending {int(res_k.n_pending)}, full-length path "
                f"{bool(took)}, mismatched fields {b1 + b2}")
            bad += b1 + b2
            err = max(err, e1, e2)
            cases += 1
    if bad:
        raise SystemExit(f"rank edge states disagree with the plain version: "
                         f"{bad} mismatched fields")
    leaves, pkt = edge_case("cold", True)
    base = state_from_numpy(leaves, dev)
    packet = torch.from_numpy(pkt).to(dev)
    kw = dict(S, max_slots=MAX_SLOTS, use_priority=True)
    k_ms = event_ms(lambda st: KERNEL(packet, st, flush=False, **kw),
                    N_TIMED, setup=lambda: clone_state(base))
    p_ms = event_ms(lambda _: _resident_tick_impl(packet, base, **kw), 10)
    cold = (statistics.median(k_ms), statistics.median(p_ms))
    log(f"phase rank edges: {cases} ticks exactly equal; the cold tick "
        f"(every slot free, priority): kernel {cold[0]:.4f} ms (min "
        f"{min(k_ms):.4f}), plain version {cold[1]:.4f} ms, medians of "
        f"{len(k_ms)} and {len(p_ms)}")
    return {"mismatches": bad, "max_abs_err": err, "cold": cold}


# -- phase 2: the resident path end to end ------------------------------------
def checked_class():
    """A ResidentScheduler subclass that records, for each kernel launch,
    the packet and a copy of the state before it, so a run can replay every
    launch through the plain version and compare. Recording makes only
    device copies inside the tick (no host sync). With ``kept`` a list,
    each tick's launch log and a copy of the state after it are appended
    there, for replaying after the run."""
    from tpu_faas_torch.sched.resident import ResidentScheduler

    class Checked(ResidentScheduler):
        record = True
        #: CUDA events around each launch (packet upload + kernel), kept
        #: while recording is off
        launch_events: list = []
        kept = None

        def _launch(self, packet, flush):
            if not self.record:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = super()._launch(packet, flush)
                b.record()
                self.launch_events.append((a, b))
                return out
            pre = clone_state(self._r_state)
            out = super()._launch(packet, flush)
            self.launch_log.append((packet.copy(), flush, pre, out))
            return out

        def tick_resident(self, now=None):
            self.launch_log = []
            out = super().tick_resident(now)
            if self.kept is not None:
                self.kept.append((self.launch_log, clone_state(self._r_state)))
            return out

    return Checked


def make_checked_scheduler(dev, clock, use_priority: bool, placement: str,
                           tenancy=None, spec: bool = False):
    """A ``checked_class`` scheduler at SHAPE. ``tenancy`` is its
    TenantTable (None: the lane off); ``spec`` turns the speculation lane
    on with config 18's knobs."""
    Checked = checked_class()
    return Checked(
        max_workers=SHAPE["W"], max_pending=SHAPE["T"],
        max_inflight=SHAPE["I"], max_slots=MAX_SLOTS, time_to_expire=10.0,
        clock=clock, device=dev, use_priority=use_priority,
        placement=placement, tenancy=tenancy,
        **(dict(spec_mult=SPEC_MULT, spec_min_s=SPEC_MIN_S, KG=KG)
           if spec else {}),
        **{k: SHAPE[k] for k in ("KA", "KH", "KF", "KI", "KS", "KB", "KP",
                                 "KR")},
    )


def replay_plain(rs, pre0, launch_log=None, final=None) -> tuple[int, float]:
    """Replay a tick's launches (by default the last tick's) through the
    plain version, starting from the state copied before the first; compare
    every launch's outputs and the final state (by default the scheduler's
    own) with the kernel's."""
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl,
    )

    kw = dict(rs._statics(), KP=rs.KP, KR=rs.KR, max_slots=rs.max_slots)
    fkw = rs._statics()
    st, bad, err = pre0, 0, 0.0
    for pkt, flush, _, out in (rs.launch_log if launch_log is None
                               else launch_log):
        packet = torch.from_numpy(pkt).to(rs.device)
        if flush:
            st, arr = _flush_kernel_impl(packet, st, **fkw)
            if not torch.equal(arr, out[1]):
                bad += 1
                log("  MISMATCH flush arrival_slots")
        else:
            res, st = _resident_tick_impl(packet, st, placement=rs.placement,
                                          **kw)
            b, e = compare(out[0], res, "out")
            bad, err = bad + b, max(err, e)
    b, e = compare(rs._r_state if final is None else final, st, "state")
    return bad + b, max(err, e)


def phase_resident(dev, n_ticks: int, timed_ticks: int,
                   placement: str = "rank", tenancy: bool = False,
                   spec: bool = False, profiler=None) -> dict:
    """The resident loop (see the module docstring); ``tenancy`` runs it with
    the tenancy lane on: ``tenant_table``'s shares and caps, arrivals
    tagged across its tenants, the table's inflight counts kept with
    note_dispatched/note_done as the dispatcher keeps them, and every
    launch's placements held to each tenant's allowance. ``spec`` runs it
    with the speculation lane on: every dispatch stamped with SPEC_PRED,
    N_STUCK live workers that never return a result, each resolved tick's
    newly flagged slots re-submitted as hedges that avoid the original's
    row, and every launch's placements held off their avoid rows.
    ``profiler`` (a TickProfiler) wraps each timed tick, as the dispatcher
    wraps its device tick."""
    from contextlib import nullcontext

    from tpu_faas_torch.sched.fused_tick import KERNEL

    def n_launches():  # rank ticks and flushes, auction and Sinkhorn ticks
        return (KERNEL.launches + KERNEL.auction_launches
                + KERNEL.sinkhorn_launches)

    auction = placement == "auction"
    sinkhorn = placement == "sinkhorn"
    W, T = SHAPE["W"], SHAPE["T"]
    # per tick: 512 results and 512 arrivals (one full arrival lane), 128
    # heartbeats; 64 rows go silent — bench.py's churn at the headline shape
    n_churn, n_hb, n_silent = SHAPE["KA"], SHAPE["KH"] // 4, W // 64
    rng = np.random.default_rng(7)
    clock_box = [1000.0]
    procs = rng.integers(1, MAX_SLOTS + 1, W)
    speeds = rng.uniform(0.5, 4.0, W)
    ten = tenant_table(int(procs.sum())) if tenancy else None
    # tenant tags draw from their own generator: the loop's other draws
    # stay those of the run without tenancy
    trng = np.random.default_rng(17)
    tenant_of: dict[str, int] = {}

    def tag(tid: str) -> int:
        tenant_of[tid] = int(trng.choice(NT_HEADLINE, p=TENANT_MIX)) \
            if tenancy else 0
        return tenant_of[tid]

    # the auction and Sinkhorn ignore priorities: their loops run FCFS
    rs = make_checked_scheduler(dev, lambda: clock_box[0],
                                use_priority=placement == "rank",
                                placement=placement, tenancy=ten, spec=spec)
    # the speculation lane's stuck rows and hedges draw from their own
    # generator too
    srng = np.random.default_rng(27)
    stuck = (set(int(x) for x in srng.choice(W, N_STUCK, replace=False))
             if spec else set())
    hedge_avoid: dict[str, int] = {}  # hedge id -> its original's row
    hedged: set[str] = set()
    # hedges queued since the last tick's arrivals: they take the place of
    # as many new arrivals, so a tick's arrivals still fill one packet lane
    queued_hedges = [0]
    for i in range(W):
        rs.register(b"w%d" % i, int(procs[i]), speed=float(speeds[i]))
    sizes: dict[str, float] = {}
    prios: dict[str, int] = {}
    ids = [f"bulk-{i}" for i in range(T)]
    bulk_sizes = rng.uniform(0.1, 10.0, T).astype(np.float32)
    bulk_prio = rng.integers(0, 4, T).astype(np.int32)
    for tid, s, p in zip(ids, bulk_sizes, bulk_prio):
        sizes[tid], prios[tid] = float(s), int(p)
    bulk_tenants = np.array([tag(tid) for tid in ids], np.int32)
    rs.pending_bulk_load(ids, bulk_sizes, bulk_prio,
                         bulk_tenants if tenancy else None)
    ptrs = [t.data_ptr() for t in rs._r_state]

    inflight: dict[str, int] = {}  # task -> row, as dispatched
    infl_list: list[str] = []
    running = np.zeros(W, np.int64)
    completed: set[str] = set()
    silenced: set[int] = set()
    silence_tick = n_ticks // 2
    n_new = 0
    stats = dict(placed=0, redispatched=0, purged=0, flushes=0,
                 steady_ticks=0, overflow_ticks=[], mismatches=0,
                 max_abs_err=0.0, cold_ticks=0, warm_ticks=0, rounds=[],
                 spilled=[], bid_rows=[], max_df=0.0, differs=0,
                 scale=0.0, over_allowance=0, on_avoid=0, flagged=0,
                 flag_ticks=0, hedges=0, hedges_placed=0,
                 placed_by_tenant=np.zeros(NT_HEADLINE, np.int64))
    expected_redispatch: set[int] | None = None
    expected_purge: set[int] | None = None
    tick_of_purge = None
    launches_at_start = n_launches()

    def resolve_one():
        nonlocal expected_redispatch, expected_purge
        r = rs.resolve_next()
        for tid, row in r.placed:
            assert tid not in inflight and tid not in completed, (
                f"{tid} placed twice")
            if tid in hedge_avoid:
                assert row != hedge_avoid[tid], f"{tid} on its avoid row"
                stats["hedges_placed"] += 1
            rs.inflight_add(tid, row, pred=SPEC_PRED if spec else 0.0)
            inflight[tid] = row
            infl_list.append(tid)
            running[row] += 1
            stats["placed"] += 1
            if ten is not None:
                ten.note_dispatched(tenant_of[tid])
                stats["placed_by_tenant"][tenant_of[tid]] += 1
        over = np.flatnonzero(running > procs)
        assert not len(over), f"rows over-booked: {over[:8]}"
        if len(r.purged_rows):
            stats["purged"] += len(r.purged_rows)
            assert expected_purge is not None, (
                f"unexpected purge {r.purged_rows[:8]}")
            assert set(int(x) for x in r.purged_rows) == expected_purge
            assert set(r.redispatch_slots) == expected_redispatch, (
                "redispatch != in-flight slots of the purged rows")
            expected_purge = None
        assert not set(r.straggler_slots) & set(r.redispatch_slots), (
            "a slot both flagged and redispatched")
        stats["flagged"] += len(r.straggler_slots)
        stats["flag_ticks"] += bool(r.straggler_slots)
        for slot in r.straggler_slots:
            # the dispatcher's hedge: the same work again, once per task,
            # kept off the worker that runs the original
            tid = rs.inflight_task[slot]
            if tid is None or tid in hedged or tid in hedge_avoid:
                continue
            hedged.add(tid)
            hid = f"hedge-{tid}"
            sizes[hid], prios[hid] = sizes[tid], prios[tid]
            tenant_of[hid] = tenant_of[tid]
            hedge_avoid[hid] = int(rs.inflight_worker[slot])
            rs.pending_add(hid, sizes[hid], prios[hid], tenant_of[hid],
                           avoid=hedge_avoid[hid])
            stats["hedges"] += 1
            queued_hedges[0] += 1
        for slot in r.redispatch_slots:
            tid = rs.inflight_clear_slot(slot)
            if tid is None:
                continue  # already reclaimed by an earlier resolve
            row = inflight.pop(tid)
            running[row] -= 1
            if ten is not None:
                ten.note_done(tenant_of[tid])
            rs.pending_add(tid, sizes[tid], prios[tid], tenant_of[tid],
                           avoid=hedge_avoid.get(tid, -1))
            stats["redispatched"] += 1
        for row in r.purged_rows:
            rs.deactivate(int(row))
        return r

    tick_ms, tick_enqueue_ms, samples = [], [], []
    timed_launches: list[int] = []  # each timed tick's kernel launches
    for k in range(n_ticks + timed_ticks):
        timed = k >= n_ticks
        rs.record = not timed
        if k == silence_tick:
            silenced.update(int(x) for x in
                            rng.choice(W, n_silent, replace=False))
            clock_box[0] += 11.0  # past time_to_expire for the silent rows
            for i in range(W):
                if i not in silenced:
                    rs.heartbeat(b"w%d" % i)
        else:
            clock_box[0] += 0.005
        # results from live rows free their slots
        done = 0
        while done < n_churn and infl_list:
            j = int(rng.integers(0, len(infl_list)))
            infl_list[j], infl_list[-1] = infl_list[-1], infl_list[j]
            tid = infl_list.pop()
            row = inflight.get(tid)
            if row is None:
                continue  # redispatched meanwhile
            if row in silenced or row in stuck:
                infl_list.insert(0, tid)
                done += 1
                continue
            del inflight[tid]
            running[row] -= 1
            completed.add(tid)
            if ten is not None:
                ten.note_done(tenant_of[tid])
            rs.release_slot(rs.inflight_done(tid))
            done += 1
        for i in range(n_hb):
            w = (k * n_hb + i) % W
            if w not in silenced:
                rs.heartbeat(b"w%d" % w)
        for _ in range(n_churn - min(queued_hedges[0], n_churn)):
            tid = f"new-{n_new}"
            n_new += 1
            sizes[tid] = float(rng.uniform(0.1, 10.0))
            prios[tid] = int(rng.integers(0, 4))
            rs.pending_add(tid, sizes[tid], prios[tid], tag(tid))
        queued_hedges[0] = 0
        if k == silence_tick:
            expected_purge = set(silenced)
            expected_redispatch = {
                int(s) for s in np.flatnonzero(
                    np.isin(rs.inflight_worker, list(silenced)))
            }
            tick_of_purge = k
        before = n_launches()
        capture = nullcontext()
        if profiler is not None and timed:
            profiler.observe_shape(tasks=T, workers=W, slots=MAX_SLOTS,
                                   signature=(placement, T, W, MAX_SLOTS))
            capture = profiler.tick_capture()
        with capture:
            torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                rs.tick_resident()
                t1 = time.perf_counter()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if profiler is not None and timed:
            profiler.note_device_dispatches(rs.device_dispatches_last_tick)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n_launch = n_launches() - before
        assert n_launch == rs.device_dispatches_last_tick
        assert [t.data_ptr() for t in rs._r_state] == ptrs, "state moved"
        if n_launch == 1:
            stats["steady_ticks"] += 1
        else:
            stats["flushes"] += n_launch - 1
            stats["overflow_ticks"].append(k)
            # only the cold start (a full buffer bouncing its first
            # arrivals), the mass-heartbeat tick and the re-queue of the
            # purged rows' tasks right after it may overflow a packet
            assert k < 16 or silence_tick <= k <= silence_tick + 4, (
                f"tick {k}: {n_launch} launches")
        if timed:
            tick_enqueue_ms.append((t1 - t0) * 1e3)
            tick_ms.append((t2 - t0) * 1e3)
            timed_launches.append(n_launch)
        else:
            if sinkhorn:
                c = replay_sinkhorn(rs)
                b = c["bad"]
                stats["max_abs_err"] = max(stats["max_abs_err"], c["dg"])
                stats["max_df"] = max(stats["max_df"], c["df"])
                stats["differs"] += c["differs"]
                stats["scale"] = max(stats["scale"], c["scale"])
            else:
                b, e = replay_plain(rs, rs.launch_log[0][2])
                stats["max_abs_err"] = max(stats["max_abs_err"], e)
            stats["mismatches"] += b
            assert b == 0, f"tick {k}: kernel != plain version ({placement})"
            pkt, _, pre, out = rs.launch_log[-1]
            if tenancy:
                over = tenancy_violations(out[0], rs._r_state.tenant, pkt)
                stats["over_allowance"] += over
                assert not over, f"tick {k}: {over} tenancy violations"
            if spec:
                on = spec_violations(out[0], rs._r_state.avoid)
                stats["on_avoid"] += on
                assert not on, f"tick {k}: {on} tasks on their avoid row"
            if auction:
                cold = bool(pre.refresh)
                stats["cold_ticks" if cold else "warm_ticks"] += 1
                stats["rounds"].append(int(out[0].auction_rounds))
                stats["spilled"].append(int(out[0].auction_spilled))
                stats["bid_rows"].append(int(out[0].auction_bid_rows))
            if n_launch == 1 and k >= n_ticks - timed_ticks:
                # the last steady ticks' packets and input states, for
                # timing the kernel alone on the main path's own data
                samples.append((torch.from_numpy(pkt).to(dev), pre,
                                stats["bid_rows"][-1] if auction else None))
        while len(rs._unresolved) > 1:  # stay two ticks deep
            resolve_one()
    while rs._unresolved:
        resolve_one()
    assert tick_of_purge is not None and expected_purge is None, (
        "the silenced rows were never purged")
    launches = n_launches() - launches_at_start
    # nothing lost: every task is completed, in flight, or pending
    pending = set(rs.slot_task.values()) | {a.task_id for a in rs._arrivals}
    pending |= {a.task_id for a in rs._rejected}
    every = set(sizes)
    accounted = completed | set(inflight) | pending
    assert accounted == every, (
        f"lost {len(every - accounted)}, unknown {len(accounted - every)}")
    assert not (completed & set(inflight)) and not (completed & pending)
    assert not (set(inflight) & pending), "a task both in flight and pending"
    if auction:
        assert stats["cold_ticks"] and stats["warm_ticks"], (
            "the auction loop needs a cold (refresh) and a warm tick")
        log(f"  auction ticks: {stats['cold_ticks']} cold, "
            f"{stats['warm_ticks']} warm; rounds {stats['rounds']}; "
            f"spilled {stats['spilled']}; bidder rows over the rounds "
            f"{stats['bid_rows']}")
    if tenancy:
        by = stats["placed_by_tenant"]
        log(f"  tenancy: placements light {by[1]}, heavy {by[2]}, the other "
            f"{NT_HEADLINE - 2} rows {by.sum() - by[1] - by[2]}; no launch "
            f"placed a tenant past its allowance; deficits at the end "
            f"{np.round(rs.tenant_deficits(), 2).tolist()}")
    if spec:
        assert stats["hedges_placed"] > 0, "no hedge was placed"
        log(f"  speculation: {stats['flagged']} straggler slots reported on "
            f"{stats['flag_ticks']} ticks, {stats['hedges']} hedges "
            f"submitted, {stats['hedges_placed']} placed, none on its avoid "
            f"row; {N_STUCK} live rows never returned a result")
    if sinkhorn:
        log(f"  Sinkhorn ticks held to the contract: max |df|/tau "
            f"{stats['max_df']:.3e}, max |dg|/tau {stats['max_abs_err']:.3e} "
            f"(bound {SINKHORN_TOL:g}), largest finite |f|/tau or |g|/tau "
            f"{stats['scale']:.3f}; {stats['differs']} checked ticks "
            f"placed otherwise than the plain version's own potentials")
    log(f"phase resident ({placement}{', tenancy' if tenancy else ''}"
        f"{', speculation' if spec else ''}): "
        f"{n_ticks + timed_ticks} ticks, "
        f"{launches} kernel "
        f"launches ({stats['steady_ticks']} ticks with exactly one; packet "
        f"overflow flushes on ticks {stats['overflow_ticks']}), "
        f"placed {stats['placed']}, purged {stats['purged']}, redispatched "
        f"{stats['redispatched']}, completed {len(completed)}, in flight "
        f"{len(inflight)}, pending {len(pending)}, lost 0")
    stats.update(launches=launches, tick_ms=tick_ms,
                 timed_launches=timed_launches,
                 tick_enqueue_ms=tick_enqueue_ms, samples=samples,
                 launch_ms=[a.elapsed_time(b) for a, b in rs.launch_events])
    return stats


# -- phase 3: SimFleet on the card --------------------------------------------
def phase_sim(dev) -> dict:
    from tpu_faas_torch.sim import SimFleet

    rng = np.random.default_rng(2)
    n_tasks = 20_000
    fleet = SimFleet(n_workers=4096, max_pending=20_480, rng=rng,
                     procs_per_worker=4, hetero=True, time_to_expire=1.0,
                     device=dev)
    sizes = rng.uniform(0.5, 3.0, n_tasks).astype(np.float32)
    t0 = time.perf_counter()
    res = fleet.run(sizes, dt=0.5, churn=0.05, max_ticks=4000)
    wall = time.perf_counter() - t0
    log(f"phase sim: 4096 workers x 4, churn 5%/tick: completed "
        f"{res.completed}/{n_tasks}, lost {res.lost}, {res.ticks} ticks, "
        f"makespan {res.makespan} sim-s, median tick "
        f"{res.median_tick_ms:.3f} ms (tick + readback), wall {wall:.1f} s")
    assert res.lost == 0 and res.completed == n_tasks
    return {"lost": res.lost, "median_tick_ms": res.median_tick_ms}


# -- phase 4: kernel B2 against its plain version -----------------------------
#: bench config 7's headline bid and BASELINE config 3's auction shape
BID_HEADLINE = (51_200, 32_768)
BID_CONFIG3 = (10_240, 4_096)
#: The bids' inner loop (csrc/bid_top2.cuh, 4 rows) as nvcc compiles it
#: (CUDA 12.8, sm_90a), counted in the SASS of the built libraries
#: (cuobjdump -sass): one pass sweeps BID_LOOP_CELLS cells (4 rows x 1
#: slot). Per pass, by issue pipe, in kernel B2 (bid_top2_kernel, the
#: sweep warp_top2) and in B1's auction branch (fused_auction_kernel, the
#: listed sweep warp_top2_listed over the kept slots):
#:   ALU (integer add, logic, shift, compare, select, min/max):
#:     SHF.R.U32.HI 16, LOP3.LUT 12, FMNMX 4, ISETP 1, and B2 FSETP 5,
#:     FSEL 4, IADD3 3, VIADD 4, B1 FSETP 4, VIADD 1: B2 49, B1 38;
#:   FMA-heavy (integer multiply, and the moves nvcc spells with it):
#:     B2 IMAD 9, IMAD.MOV.U32 22, IMAD.X 3: 34; B1 IMAD 12,
#:     IMAD.MOV.U32 16, IMAD.WIDE 3: 31;
#:   FMA heavy or lite (float32): FMUL 12, FADD 8 = 20;
#:   XU (conversion): I2FP.F32.S32 4;
#:   besides 3 loads and a branch (B2), and a uniform, 3 constant and 3
#:   global loads and a branch (B1): 111 instructions in all in B2, 101 in
#:   B1. The bound takes the fewer of the two copies on each pipe and in
#:   all: the least the same work has compiled to.
BID_LOOP_CELLS = 4
BID_ALU, BID_IMAD, BID_F32, BID_CVT, BID_ALL = 38, 31, 20, 4, 101
#: instructions each pipe of an SM issues per clock on sm_90 (NVIDIA's
#: arithmetic instruction throughputs, compute capability 9.0): integer,
#: logic and compare 64; integer multiply 64, on the FMA-heavy half;
#: float32 add and multiply 128, on both halves; conversions 16; and any
#: instruction 128 (each of the 4 schedulers issues one warp's a clock)
ALU_PER_SM_CLOCK, IMAD_PER_SM_CLOCK = 64, 64
F32_PER_SM_CLOCK, CVT_PER_SM_CLOCK, ISSUE_PER_SM_CLOCK = 128, 16, 128


#: the pipe each SASS opcode of the bid loop issues to (its base name, the
#: text before the first dot); None: a load or branch unit
SASS_PIPE = {"IMAD": "FMA-heavy", "FMUL": "float32", "FADD": "float32",
             "FFMA": "float32", "I2FP": "conversion", "I2F": "conversion",
             "LDG": None, "LD": None, "LDC": None, "ULDC": None, "BRA": None}


def sass_loop_counts(lib, kernel: str) -> dict:
    """The bid loop of ``kernel`` in the built library ``lib``, counted
    from ``cuobjdump -sass``: the shortest loop (a backward branch and the
    code it jumps over) with four int->float conversions. Returns its
    instructions by pipe (``SASS_PIPE``, ALU for the rest) and by
    opcode."""
    import collections
    import os
    import re

    from tpu_faas_torch.build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs = text.split("Function : ")
    (body,) = [f for f in funcs[1:] if kernel in f.splitlines()[0]]
    code = []  # (address, opcode, branch target or None)
    for line in body.splitlines():
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)(?:\s+(0x[0-9a-f]+))?", line)
        if m:
            target = int(m[3], 16) if m[2].startswith("BRA") and m[3] else None
            code.append((int(m[1], 16), m[2], target))
    loops = []
    for at, op, target in code:
        if target is not None and target < at:
            ops = [o for a, o, _ in code if target <= a <= at]
            if sum(o.startswith("I2F") for o in ops) == 4:
                loops.append(ops)
    ops = min(loops, key=len)
    by_op = collections.Counter(ops)
    by_pipe = collections.Counter()
    for o, n in by_op.items():
        pipe = SASS_PIPE.get(o.split(".")[0], "ALU")
        if pipe:
            by_pipe[pipe] += n
    return {"pipes": dict(by_pipe), "ops": dict(by_op), "n": len(ops)}


def log_bid_loops() -> None:
    """Count the bid loop of B2 and of B1's auction branch in the built
    libraries and set them beside the bound's constants."""
    from tpu_faas_torch.build import library_path

    counts = []
    # B1's auction: the instance with both lanes off (its mangled name)
    for lib, kernel, name in (
            ("bid_top2", "bid_top2_kernel", "bid_top2_kernel"),
            ("fused_tick", "fused_auction_kernelILb0E",
             "fused_auction_kernel<false>")):
        c = sass_loop_counts(library_path(lib), kernel)
        counts.append(dict(c["pipes"], all=c["n"]))
        log(f"  SASS of {name}'s bid loop ({c['n']} instructions per "
            f"{BID_LOOP_CELLS} cells): by pipe {c['pipes']}; by opcode "
            f"{c['ops']}")
    least = {p: min(c.get(p, 0) for c in counts)
             for p in ("ALU", "FMA-heavy", "float32", "conversion", "all")}
    want = {"ALU": BID_ALU, "FMA-heavy": BID_IMAD, "float32": BID_F32,
            "conversion": BID_CVT, "all": BID_ALL}
    log(f"  the fewer of the two per pipe {least}; the bound's constants "
        f"{want}" + ("" if least == want else
                      " -- they differ: recount the constants"))


def bid_cell_clocks() -> tuple[float, str]:
    """SM clocks per (row, slot) cell of the bids on the pipe that binds,
    and its name: the ALU's, the FMA pipes' (IMAD on the heavy half alone,
    float32 on either), the conversion's, or the schedulers' issue of
    every instruction."""
    per = {
        "ALU": BID_ALU / ALU_PER_SM_CLOCK,
        "FMA": max(BID_IMAD / IMAD_PER_SM_CLOCK,
                   (BID_IMAD + BID_F32) / F32_PER_SM_CLOCK),
        "conversion": BID_CVT / CVT_PER_SM_CLOCK,
        "issue": BID_ALL / ISSUE_PER_SM_CLOCK,
    }
    pipe = max(per, key=per.get)
    return per[pipe] / BID_LOOP_CELLS, pipe


def bid_pipe_text(clock_hz: float) -> str:
    clocks, pipe = bid_cell_clocks()
    return (f"{clocks:.4f} SM clocks a cell on the {pipe} pipe "
            f"({BID_ALL} instructions per {BID_LOOP_CELLS} cells: {BID_ALU} "
            f"ALU, {BID_IMAD} IMAD, {BID_F32} float32, {BID_CVT} "
            f"conversions), "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} "
            f"SMs at {clock_hz / 1e9:.3f} GHz")


def bid_cells_ms(cells: int, clock_hz: float) -> float:
    """The least time for ``cells`` bid cells spread over every SM at
    ``clock_hz``, on the pipe that binds."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return cells * bid_cell_clocks()[0] / (n_sm * clock_hz) * 1e3


def bid_inputs(dev, T: int, S: int, seed: int, frac_valid: float = 1.0):
    """Config 7's bid inputs: lognormal sizes, inv_speed U(0.25, 2), price
    U(0, 1)."""
    rng = np.random.default_rng(seed)
    valid = (rng.random(S) < frac_valid) if frac_valid < 1 else np.ones(S)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.lognormal(0.0, 1.0, T), rng.uniform(0.25, 2.0, S),
        valid, rng.uniform(0.0, 1.0, S))]


def bid_bound_ms(T: int, S: int, clock_hz: float) -> tuple[float, str]:
    """The least time for one bid: the larger of its cells' instructions
    on the pipe that binds (``bid_cell_clocks``) and its bytes (inputs
    once, outputs once) at the HBM rate."""
    ops_ms = bid_cells_ms(T * S, clock_hz)
    bytes_ms = (4 * T + 12 * S + 12 * T) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def bid_nan_cases(dev) -> list:
    """ROADMAP C.3's inputs for B2: a NaN size on some rows, a NaN speed on
    one valid slot, a NaN price on two valid slots, a NaN jitter, and an
    infinite product against an infinite price (inf - inf), each at the
    headline's slot count and beside finite rows."""
    T, S = 4096, BID_HEADLINE[1]
    cases = []
    for name in ("NaN size", "NaN speed on one valid slot", "NaN price",
                 "NaN jitter", "inf - inf"):
        ts, inv, valid, price = bid_inputs(dev, T, S, 70 + len(cases), 0.9)
        js = 1e-4
        slot = 20_011
        valid[slot] = 1.0
        if name == "NaN size":
            ts[[3, 999, 1000, T - 1]] = float("nan")
        elif name == "NaN speed on one valid slot":
            inv[slot] = float("nan")
        elif name == "NaN price":
            price[[slot, S - 1]] = float("nan")
            valid[S - 1] = 1.0
        elif name == "NaN jitter":
            js = float("nan")
        else:
            ts[[5, 6]] = float("-inf")
            price[slot] = float("inf")
        cases.append((f"C.3 {name}", [ts, inv, valid, price], js, {}))
    return cases


def phase_bid(dev) -> dict:
    """B2 against its plain version on the card, exactly equal on v1,
    best and v2, at config 7's and config 3's shapes and the edge cases."""
    from tpu_faas_torch.sched.bid import KERNEL, bid_top2_stream_impl

    cases = []
    T, S = BID_HEADLINE
    cases.append(("config 7 headline", bid_inputs(dev, T, S, 7), 1e-4, {}))
    T, S = BID_CONFIG3
    cases.append(("config 3", bid_inputs(dev, T, S, 33, 0.8), 2.5e-4, {}))
    cases.append(("ragged 1000x3001", bid_inputs(dev, 1000, 3001, 1, 0.6),
                  2.5e-4, {}))
    ts, inv, _, price = bid_inputs(dev, 2048, 3001, 2)
    cases.append(("all slots invalid", [ts, inv, torch.zeros_like(inv),
                                        price], 2.5e-4, {}))
    one = torch.zeros_like(inv)
    one[1777] = 1.0
    cases.append(("one valid slot", [ts, inv, one, price], 2.5e-4, {}))
    # a max duplicated across lanes and strides, zero jitter keeps the tie
    dup_price = torch.ones(4096, device=dev)
    dup_price[[37, 69, 2048 + 911, 4000]] = 0.0
    cases.append(("duplicated max, zero jitter",
                  [torch.ones(1024, device=dev), torch.ones(4096, device=dev),
                   torch.ones(4096, device=dev), dup_price], 0.0, {}))
    cases.append(("row_offset/n_slots_total past 2^32",
                  bid_inputs(dev, 2000, 3001, 3, 0.7), 2.5e-4,
                  dict(row_offset=2**20 + 5, n_slots_total=8193)))
    cases += bid_nan_cases(dev)
    mismatches = 0
    for name, args, js, kw in cases:
        js = float(np.float32(js))
        got = KERNEL(*args, js, **kw)
        want = bid_top2_stream_impl(*args, js, **kw)
        torch.cuda.synchronize()
        # a NaN equals a NaN in the same place (C.3's cases)
        bad = [f for f, a, b in zip(("v1", "best", "v2"), got, want)
               if not same(a, b)]
        if name.startswith("C.3"):
            nan_v1 = int(torch.isnan(got[0]).sum())
            bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got[0::2], want[0::2]))
            log(f"  {name}: rows with v1 NaN {nan_v1}, with v2 NaN "
                f"{int(torch.isnan(got[2]).sum())}, float bits "
                f"{'equal' if bits else 'differ in a NaN payload'}")
        if name == "duplicated max, zero jitter":
            assert bool((got[1] == 37).all()), "duplicate max: wrong argmax"
            assert torch.equal(got[0], got[2]), "duplicate max: v2 != v1"
        if name == "all slots invalid":
            assert bool((got[1] == 0).all() & torch.isinf(got[0]).all())
        log(f"  {name} ({args[0].shape[0]} x {args[1].shape[0]}): "
            f"mismatched outputs {bad or 'none'}")
        mismatches += len(bad)
    if mismatches:
        raise SystemExit(f"bid_top2 disagrees with its plain version: "
                         f"{mismatches} mismatched outputs")
    log(f"phase bid: {len(cases)} cases exactly equal")
    return {"mismatches": 0, "max_abs_err": 0.0}


# -- phase 5: the batch auction tick ------------------------------------------
def check_assignment(assignment, task_valid, worker_free, worker_live):
    """Capacity respected, live workers only, no padding rows placed (the
    JAX suite's check, copied: this script imports nothing of it)."""
    assert assignment.shape == task_valid.shape
    assert (assignment[~task_valid] == -1).all(), "padding rows assigned"
    used = assignment[assignment >= 0]
    if used.size:
        counts = np.bincount(used, minlength=len(worker_free))
        assert (counts <= worker_free).all(), "capacity violated"
        assert worker_live[used].all(), "dead worker assigned"


def auction_fleets():
    """(name, max_slots, W, speeds, T, per-tick sizes): BASELINE config 3's
    two legs (10,000 tasks on 1,000 workers x 4, padded to 10,240 x 1,024)
    and the headline shape (51,200 pending, 4,096 x 8). Every worker
    registers max_slots processes."""
    n, w = 10_000, 1_000
    uni = [np.full(n, 1.0, np.float32) + np.float32((i + 1) * 1e-6)
           for i in range(4)]
    rng = np.random.default_rng(33)
    speeds = rng.uniform(0.5, 4.0, w).astype(np.float32)
    base = rng.lognormal(0.0, 1.0, n).astype(np.float32)
    logn = [(base * (1 + i * 1e-4)).astype(np.float32) for i in range(4)]
    rng = np.random.default_rng(51)
    hspeeds = rng.uniform(0.5, 4.0, 4096).astype(np.float32)
    hbase = rng.lognormal(0.0, 1.0, 51_200).astype(np.float32)
    head = [(hbase * (1 + i * 1e-4)).astype(np.float32) for i in range(3)]
    return [
        ("config 3 uniform", 4, 1024, np.ones(w, np.float32), 10_240, uni),
        ("config 3 lognormal", 4, 1024, speeds, 10_240, logn),
        ("headline", 8, 4096, hspeeds, 51_200, head),
    ]


def make_auction_arrays(dev, W, T, max_slots, speeds):
    from tpu_faas_torch.sched.state import SchedulerArrays

    sa = SchedulerArrays(max_workers=W, max_pending=T, max_inflight=4096,
                         max_slots=max_slots, clock=lambda: 1000.0,
                         placement="auction", device=dev)
    for i, s in enumerate(speeds):
        sa.register(b"w%d" % i, max_slots, speed=float(s))
    return sa


class plain_bids:
    """Within this block the auction bids with the plain version on the
    card (a replay's reference), never launching B2."""

    def __enter__(self):
        from tpu_faas_torch.sched import auction, bid

        self._mod, self._real = auction, auction.bid_top2
        auction.bid_top2 = bid.bid_top2_stream_impl

    def __exit__(self, *exc):
        self._mod.bid_top2 = self._real


def phase_auction(dev) -> dict:
    """SchedulerArrays(placement="auction") on the card, ticking each fleet
    with the price carry beside a twin whose bids are the plain version.
    Every tick: a legal, complete assignment, and the twin's tick equal on
    assignment, rounds, prices, refresh and spilled count."""
    from tpu_faas_torch.sched.bid import KERNEL

    stats = {"ticks": 0, "mismatches": 0, "rounds": {}, "arrays": {}}
    for name, K, W, speeds, T, batches in auction_fleets():
        sa = make_auction_arrays(dev, W, T, K, speeds)
        twin = make_auction_arrays(dev, W, T, K, speeds)
        free = np.minimum(sa.worker_free, K)
        for k, sizes in enumerate(batches):
            before = KERNEL.launches
            out = sa.tick(sizes)
            torch.cuda.synchronize()
            launches = KERNEL.launches - before
            with plain_bids():
                ref = twin.tick(sizes)
            a = out.assignment.cpu().numpy()
            valid = np.arange(T) < len(sizes)
            check_assignment(a, valid, free, sa.worker_active.copy())
            placed = int((a >= 0).sum())
            assert placed == min(len(sizes), int(free.sum())), (
                f"{name} tick {k}: placed {placed}")
            assert launches == out.auction_rounds, (
                f"{name} tick {k}: {launches} launches, "
                f"{out.auction_rounds} rounds")
            bad = [f for f in ("assignment", "auction_price",
                               "auction_refresh", "auction_spilled")
                   if not torch.equal(getattr(out, f), getattr(ref, f))]
            bad += [f for f in ("auction_rounds", "auction_bid_rows")
                    if getattr(out, f) != getattr(ref, f)]
            log(f"  {name} tick {k} ({'warm' if k else 'cold'}): placed "
                f"{placed}, rounds {out.auction_rounds}, spilled "
                f"{int(out.auction_spilled)}, refresh "
                f"{bool(out.auction_refresh)}, B2 launches {launches}, "
                f"plain-bid twin mismatches {bad or 'none'}")
            stats["mismatches"] += len(bad)
            stats["ticks"] += 1
            stats["rounds"].setdefault(name, []).append(out.auction_rounds)
        stats["arrays"][name] = (sa, batches)
    if stats["mismatches"]:
        raise SystemExit(f"auction ticks disagree with their plain-bid "
                         f"replay: {stats['mismatches']} fields")
    log(f"phase auction: {stats['ticks']} ticks, every one legal, complete "
        f"and equal to its plain-bid twin")
    return stats


# -- phase 6: the resident auction (B1's auction branch) ---------------------
def auction_bound_ms(bid_rows: int, n_match: int, packet: torch.Tensor,
                     clock_hz: float) -> tuple[float, str]:
    """The least time for one resident auction tick: the larger of the
    bids' instructions on the pipe that binds (``bid_cell_clocks``) over
    the (bidder, slot) cells this tick's rounds needed (``bid_rows``, the
    bidders summed over the rounds, times ``n_match``, the kept slots: a
    slot outside them bids -inf and needs nothing), and its bytes at the
    HBM rate: the rank tick's, plus the carried prices read and written
    (every one re-based), the refresh flag, the four aux counts, and the
    opening's and close's lists at n_match entries (the kept slots' ids,
    inverse speeds and prices, the admitted tasks' ids), each written once
    and read once."""
    S = SHAPE["W"] * MAX_SLOTS
    ops_ms = bid_cells_ms(bid_rows * n_match, clock_hz)
    bytes_ms = (bound_ms(False, packet)
                + (8 * S + 2 + 16 + 2 * 16 * n_match) / HBM_BYTES_PER_S
                * 1e3)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def auction_case(seed: int, use_priority: bool, refresh: bool):
    """``random_case``'s state and packet, with carried prices k/16 and the
    refresh flag set as asked."""
    rng = np.random.default_rng(seed)
    leaves, pkt = random_case(rng, use_priority, now=100.0)
    S = SHAPE["W"] * MAX_SLOTS
    leaves["price"] = (rng.integers(0, 64, S) / 16).astype(np.float32)
    leaves["refresh"] = np.asarray(refresh)
    return leaves, pkt


def compare_auction_tick(dev, leaves, pkt, use_priority: bool, label: str,
                         plain_twin: bool, tenancy: bool = False,
                         spec: bool = False, nt: int = NT_HEADLINE):
    """The auction kernel against its plain version from the same state,
    and (``plain_twin``) against the plain version with plain bids:
    (mismatched fields and tenancy or avoid-row violations, max abs error,
    rounds, spilled, bidder rows). ``tenancy``, ``spec``: the packet
    carries that lane (``nt`` tenant rows)."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _resident_tick_impl, state_from_numpy,
    )

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority,
              **(dict(use_tenancy=True, NT=nt) if tenancy else {}),
              **(SPEC_KW if spec else {}))
    st_k = state_from_numpy(leaves, dev)
    packet = torch.from_numpy(pkt).to(dev)
    ptrs = [t.data_ptr() for t in st_k]
    res_k, new_k = KERNEL.auction(packet, st_k, **kw)
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in new_k] == ptrs, "state moved"
    bad, err = 0, 0.0
    twins = [("B2 bids", None)] + ([("plain bids", plain_bids)]
                                   if plain_twin else [])
    for twin, bids in twins:
        if bids is None:
            res_p, new_p = _resident_tick_impl(
                packet, state_from_numpy(leaves, dev), placement="auction",
                **kw)
        else:
            with bids():
                res_p, new_p = _resident_tick_impl(
                    packet, state_from_numpy(leaves, dev),
                    placement="auction", **kw)
        b1, e1 = compare(res_k, res_p, f"{label} vs {twin}: out")
        b2, e2 = compare(new_k, new_p, f"{label} vs {twin}: state")
        bad, err = bad + b1 + b2, max(err, e1, e2)
    if tenancy:
        bad += tenancy_violations(res_k, new_k.tenant, pkt, nt)
    if spec:
        bad += spec_violations(res_k, new_k.avoid)
    return (bad, err, int(res_k.auction_rounds), int(res_k.auction_spilled),
            int(res_k.auction_bid_rows))


def few_bidder_case(seed: int):
    """A warm tick with few bidders: ``auction_case``'s state with carried
    prices, 13 free slots on live rows and 14 valid tasks (one slot short),
    and a packet with no deltas, so every round has at most 13 bidders."""
    leaves, pkt = auction_case(seed, False, refresh=False)
    rng = np.random.default_rng(100 + seed)
    T, W = SHAPE["T"], SHAPE["W"]
    now, tte = np.float32(pkt[0]), np.float32(pkt[8])
    live = np.flatnonzero(leaves["active"]
                          & (now - leaves["last_hb"] <= tte))
    free = np.zeros(W, np.int32)
    free[rng.choice(live, 13, replace=False)] = 1
    valid = np.zeros(T, bool)
    valid[rng.choice(T, 14, replace=False)] = True
    pkt = pkt.copy()
    pkt[1:7] = 0
    return dict(leaves, free=free, valid=valid), pkt


def all_bid_case(seed: int):
    """A cold tick in which every admitted task bids: ``auction_case``'s
    state from the seed (refresh set), every task valid and every row's
    slots free, and a packet with no deltas, so the first round's bidders
    are as many as the live rows' slots."""
    leaves, pkt = auction_case(seed, False, refresh=True)
    pkt = pkt.copy()
    pkt[1:7] = 0
    return dict(leaves, free=np.full(SHAPE["W"], MAX_SLOTS, np.int32),
                valid=np.ones(SHAPE["T"], bool)), pkt


def nan_auction_cases():
    """ROADMAP C.3's inputs for B1's auction branch, on ``auction_case``'s
    states: NaN sizes in the state and the arrival lane (cold and warm), a
    NaN speed on live rows with free slots, and NaN carried prices (warm)."""
    out = []
    for label, refresh in (("C.3 NaN sizes, cold", True),
                           ("C.3 NaN sizes, warm", False),
                           ("C.3 NaN speeds", True),
                           ("C.3 NaN prices, warm", False)):
        leaves, pkt = auction_case(40 + len(out), False, refresh)
        rng = np.random.default_rng(50 + len(out))
        leaves = dict(leaves)
        if "sizes" in label:
            sizes = leaves["sizes"].copy()
            sizes[rng.choice(SHAPE["T"], 64, replace=False)] = np.nan
            leaves["sizes"] = sizes
            pkt = pkt.copy()
            pkt[9 + rng.choice(int(pkt[1]), 8, replace=False)] = np.nan
        elif "speeds" in label:
            speed = leaves["speed"].copy()
            rows = rng.choice(SHAPE["W"], 3, replace=False)
            speed[rows] = np.nan
            free = leaves["free"].copy()
            free[rows] = MAX_SLOTS
            leaves.update(speed=speed, free=free,
                          active=leaves["active"] | np.isin(
                              np.arange(SHAPE["W"]), rows))
        else:
            price = leaves["price"].copy()
            price[rng.choice(price.size, 16, replace=False)] = np.nan
            leaves["price"] = price
        out.append((label, (leaves, pkt)))
    return out


def phase_auction_kernel(dev, probe) -> dict:
    """B1's auction branch against its plain version on the card, at the
    headline shape: refresh on and off, priority lanes on and off, two
    seeds; a warm tick with few bidders and a cold tick in which every
    admitted task bids; every output and state leaf exactly equal, round
    and spilled counts included. Seed 0 is also held against the plain
    version with plain bids. The few-bidder and every-bidder ticks are also
    run once on ``probe`` (the probe build) for their round split."""
    from tpu_faas_torch.sched.resident import state_from_numpy

    mismatches, max_err, cases = 0, 0.0, 0
    for refresh in (True, False):
        for use_priority in (False, True):
            for seed in (0, 1):
                leaves, pkt = auction_case(seed, use_priority, refresh)
                label = f"refresh={refresh} prio={use_priority} seed={seed}"
                # the plain-bid twin costs up to 64 plain sweeps of 1.7e9
                # cells: seed 0 only
                b, e, rounds, spilled, bid_rows = compare_auction_tick(
                    dev, leaves, pkt, use_priority, label,
                    plain_twin=seed == 0)
                log(f"  {label}: rounds {rounds}, spilled {spilled}, bidder "
                    f"rows {bid_rows}, mismatched fields {b}")
                mismatches += b
                max_err = max(max_err, e)
                cases += 1
    for label, (leaves, pkt) in nan_auction_cases():
        # C.3: each bid's NaN cells take JAX's rule in the kernel too
        b, e, rounds, spilled, bid_rows = compare_auction_tick(
            dev, leaves, pkt, False, label, plain_twin=label.endswith(
                "NaN sizes, cold"))
        log(f"  {label}: rounds {rounds}, spilled {spilled}, bidder rows "
            f"{bid_rows}, mismatched fields {b}")
        mismatches += b
        max_err = max(max_err, e)
        cases += 1
    for label, (leaves, pkt) in (("few bidders", few_bidder_case(3)),
                                 ("every task bids", all_bid_case(4))):
        b, e, rounds, spilled, bid_rows = compare_auction_tick(
            dev, leaves, pkt, False, label, plain_twin=False)
        packet = torch.from_numpy(pkt).to(dev)
        sp, bp = auction_split(dev, probe, packet,
                               state_from_numpy(leaves, dev))
        log(f"  {label}: rounds {rounds}, spilled {spilled}, bidder rows "
            f"{bid_rows}, mismatched fields {b + bp}; split (probe build, "
            f"block 0's clock): {split_text(sp)}; rounds (bidders: bids us) "
            f"{rounds_text(sp)}")
        mismatches += b + bp
        max_err = max(max_err, e)
        cases += 1
    if mismatches:
        raise SystemExit(f"the auction kernel disagrees with its plain "
                         f"version: {mismatches} mismatched fields")
    log(f"phase auction kernel: {cases} ticks exactly equal")
    return {"mismatches": 0, "max_abs_err": max_err}


def auction_split(dev, probe, packet, pre,
                  kw: dict | None = None) -> tuple[dict, int]:
    """One launch of the probe build from ``pre`` (left untouched), beside
    one of the kernel proper: (the probe's split, fields that differ
    between the two launches). ``kw``: the launch's shape and lanes (FCFS
    at the headline shape by default)."""
    from tpu_faas_torch.sched.fused_tick import KERNEL

    kw = kw or dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    res_k, st_k = KERNEL.auction(packet, clone_state(pre), **kw)
    res_p, st_p = probe.auction(packet, clone_state(pre), **kw)
    sp = probe.auction_split(dev, SHAPE["T"], SHAPE["W"], MAX_SLOTS)
    b1, _ = compare(res_p, res_k, "probe build: out")
    b2, _ = compare(st_p, st_k, "probe build: state")
    return sp, b1 + b2


def resident_auction_split(dev, probe, samples: list) -> dict:
    """The round split on the resident auction loop's own states: one
    launch of the probe build each, beside the kernel proper; then each
    round's parts averaged over every round of those launches, and the bid
    time of the rounds grouped by their bidders."""
    splits, bad = [], 0
    for i, (packet, pre, _) in enumerate(samples):
        sp, b = auction_split(dev, probe, packet, pre)
        bad += b
        splits.append(sp)
        log(f"  state {i} ({'cold' if bool(pre.refresh) else 'warm'}): "
            f"{split_text(sp)}")
        log(f"    rounds (bidders: bids us) {rounds_text(sp)}")
    rounds = [r for sp in splits for r in sp["rounds"]]
    means = [statistics.mean(r[i] for r in rounds) * 1e3 for i in range(1, 5)]
    log(f"  per round, means over the {len(rounds)} rounds of the "
        f"{len(splits)} states: bids {means[0]:.2f} us, their barrier "
        f"{means[1]:.2f} us, install+barrier {means[2]:.2f} us, "
        f"collection+barrier {means[3]:.2f} us")
    for lo, hi in ((1, 32), (33, 256), (257, 1024), (1025, 1 << 30)):
        sel = [r[1] * 1e3 for r in rounds if lo <= r[0] <= hi]
        if sel:
            log(f"  rounds with {lo}-{min(hi, SHAPE['T'])} bidders: "
                f"{len(sel)}, bids {statistics.mean(sel):.2f} us mean "
                f"(min {min(sel):.2f}, max {max(sel):.2f})")
    return {"mismatches": bad, "splits": splits, "round_means_us": means}


def split_text(sp: dict) -> str:
    """A split with its rounds summed: bids, their barriers, installs and
    collections (each with its barrier)."""
    bids, bar, inst, coll = (sum(r[i] for r in sp["rounds"])
                             for i in range(1, 5))
    return (f"opening {sp['open']:.4f} ms + seed/rebase {sp['seed']:.4f} ms "
            f"+ first barrier {sp['start']:.4f} ms; {len(sp['rounds'])} "
            f"rounds: bids {bids:.4f} ms, their barriers {bar:.4f} ms, "
            f"install+barrier {inst:.4f} ms, collection+barrier {coll:.4f} "
            f"ms; close {sp['close']:.4f} ms, fixup/deficit/compaction "
            f"{sp['end']:.4f} ms; launch {sp['total']:.4f} ms")


def rounds_text(sp: dict) -> str:
    return " ".join(f"{n}:{b * 1e3:.1f}" for n, b, *_ in sp["rounds"])


def time_resident_auction(dev, samples: list, n_match: list[int]) -> dict:
    """The auction kernel per tick on the resident auction loop's own
    states, beside its bound and its plain version on the card, each state
    timed once by each; ``n_match``, each state's kept slots (the probe
    build's count, ``resident_auction_split``). The plain version bids with the plain top-2, and
    each of its ticks is also held exactly against the kernel's from the
    same state: the comparison on the loop's states that shares no code
    with the kernel. The plain tick with B2's bids is context. Warm and
    cold ticks differ forty-fold in their bidders, so the entry's numbers
    are means over the same states, and each kind's medians are logged."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import _resident_tick_impl

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    n = len(samples)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % n]
        return packet, clone_state(pre)

    def plain(a):
        return _resident_tick_impl(a[0], a[1], placement="auction", **kw)

    # n consecutive timed calls after 3 warm-ups: every state once; the
    # kernel's timed call j ran state (j + 3) % n
    k_ms = event_ms(lambda a: KERNEL.auction(a[0], a[1], **kw), n,
                    setup=next_sample)
    k_of = {(j + 3) % n: t for j, t in enumerate(k_ms)}
    b2_ms = event_ms(plain, n, setup=next_sample)
    bad, err, p_ms = 0, 0.0, []
    for i, (packet, pre, _) in enumerate(samples):
        res_k, st_k = KERNEL.auction(packet, clone_state(pre), **kw)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with plain_bids():
            a.record()
            res_p, st_p = plain((packet, clone_state(pre)))
            b.record()
        torch.cuda.synchronize()
        p_ms.append(a.elapsed_time(b))
        b1, e1 = compare(res_k, res_p, f"loop state {i} vs plain bids: out")
        b2, e2 = compare(st_k, st_p, f"loop state {i} vs plain bids: state")
        bad, err = bad + b1 + b2, max(err, e1, e2)
    if bad:
        raise SystemExit(f"the auction kernel disagrees with its plain "
                         f"version with plain bids on the loop's states: "
                         f"{bad} mismatched fields")
    clock = sm_clock_hz()
    bounds = [auction_bound_ms(r, n, p.cpu(), clock)
              for (p, _, r), n in zip(samples, n_match, strict=True)]
    out = {"ms": statistics.mean(k_ms), "plain_ms": statistics.mean(p_ms),
           "bound_ms": statistics.mean(b for b, _ in bounds),
           "bound_by": statistics.mode(by for _, by in bounds),
           "mismatches": bad, "max_abs_err": err}
    for kind in ("warm", "cold"):
        idx = [i for i, (_, pre, _) in enumerate(samples)
               if bool(pre.refresh) == (kind == "cold")]
        if not idx:
            continue
        log(f"  {kind} states ({len(idx)}): bidder rows "
            f"{[samples[i][2] for i in idx]}, kept slots "
            f"{[n_match[i] for i in idx]}; medians: kernel "
            f"{statistics.median(k_of[i] for i in idx):.4f} ms, bound "
            f"{statistics.median(bounds[i][0] for i in idx):.4f} ms, plain "
            f"version with plain bids "
            f"{statistics.median(p_ms[i] for i in idx):.1f} ms")
    every_row = bid_cells_ms(64 * SHAPE["T"] * SHAPE["W"] * MAX_SLOTS, clock)
    log(f"  auction kernel on the resident auction run's {n} states, means: "
        f"{out['ms']:.4f} ms (min {min(k_ms):.4f}, max {max(k_ms):.4f}); "
        f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}: bidder rows x "
        f"kept slots x {bid_pipe_text(clock)}), "
        f"kernel/bound "
        f"{out['ms'] / out['bound_ms']:.1f}; plain version with plain bids "
        f"{out['plain_ms']:.1f} ms, exactly equal on every state; plain "
        f"tick with B2's bids {statistics.mean(b2_ms):.4f} ms; were every "
        f"row to bid in 64 rounds, {every_row:.4f} ms")
    return out


# -- phase 7: the resident Sinkhorn tick (B1's Sinkhorn branch) -------------
#: contract (b): the largest |df|/tau and |dg|/tau allowed between the kernel's
#: final potentials and the plain version's from the same state (PERF.md)
SINKHORN_TOL = 1e-4
N_SINKHORN_TICKS = 40  # checked resident Sinkhorn ticks
N_SINKHORN_TIMED = 10  # timed resident Sinkhorn ticks
#: exps per SM per clock on the special function units (Hopper)
SFU_PER_SM_CLOCK = 16
#: the dense route's check: T*W = 2^24, so 60 iterations on [T+1, W+1]
DENSE_SHAPE = dict(SHAPE, T=4_096)


def potential_err(a: torch.Tensor, b: torch.Tensor, tau: float) -> float:
    """max |a - b| / tau over the finite entries; inf unless the non-finite
    entries are the same values in the same places."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return float("inf")
    if not bool(fa.any()):
        return 0.0
    return float((a[fa].double() - b[fa].double()).abs().max()) / tau


def sinkhorn_legal(pre, res, new, K: int, KP: int,
                   spec_counts: tuple[int, int] | None = None) -> list[str]:
    """Contract (d) on one launch's outputs: no row over its capacity, no
    dead row, no task placed twice or placed without being pending, and
    the count placed = min(KP, valid tasks, total capacity). With the
    speculation lane (``spec_counts``: the tasks the main pass and the
    fixup placed in all, and the vetoed tasks the fixup left queued): a
    row's capacity is the fixup's, its raw free count; no task lands on
    its avoid row; and the count placed = min(KP, the main pass's count
    less the vetoed tasks left queued), the main pass's count being
    min(valid tasks, total capacity)."""
    W = new.free.shape[0]
    ok = res.placed_slots >= 0
    slots = res.placed_slots[ok].long()
    rows = res.placed_rows[ok].long()
    per_row = torch.bincount(rows, minlength=W).to(torch.int32)
    free_before = new.free + per_row  # the tick took one slot per placement
    cap = torch.where(res.live, free_before.clamp(max=K), 0).clamp_min(0)
    raw = torch.where(res.live, free_before, 0).clamp_min(0)
    n = int(ok.sum())
    pending = pre.valid.clone()
    arr = res.arrival_slots[res.arrival_slots >= 0].long()
    pending[arr] = True
    bad = []
    if bool((per_row > (cap if spec_counts is None else raw)).any()):
        bad.append("a row over its capacity")
    if not bool(res.live[rows].all()):
        bad.append("a dead row placed")
    if slots.unique().numel() != n:
        bad.append("a task placed twice")
    if not bool(pending[slots].all()) or bool(new.valid[slots].any()):
        bad.append("a placed task that was not pending")
    valid = n + int(res.n_pending)
    if res.tenant_eligible is not None:  # tenancy: placement's valid set
        valid = int(res.tenant_eligible.sum())
        if not bool(res.tenant_eligible[slots].all()):
            bad.append("a placed task that was not eligible")
    if spec_counts is None:
        if n != min(KP, valid, int(cap.sum())):
            bad.append("placed != min(KP, valid, capacity)")
        return bad
    total, left = spec_counts
    if bool((new.avoid[slots] == rows).any()):
        bad.append("a task placed on its avoid row")
    if n != min(KP, total) or total != min(valid, int(cap.sum())) - left:
        bad.append("placed != min(KP, valid, capacity) - vetoed left queued")
    return bad


def spec_fixup_counts(pre, packet, res_k, avoid, kw: dict) -> tuple[int,
                                                                    int]:
    """For contract (d) with the speculation lane: the kernel's main-pass
    assignment, as the plain rounding takes it from the kernel's own
    potentials with no avoid row anywhere and every placement reported;
    then the plain fixup on it, with ``avoid`` the avoid leaf after the
    packet. Returns (tasks placed in all, vetoed tasks left queued)."""
    from tpu_faas_torch.sched.resident import _resident_tick_impl
    from tpu_faas_torch.spec.straggler import hedge_fixup_impl

    T = kw["T"]
    lanes = 1 + int(kw["use_priority"]) + int(kw.get("use_tenancy", False))
    at = 9 + kw["KA"] * lanes  # the arrivals' avoid lane
    pk = packet.clone()
    pk[at : at + kw["KA"]] = -1.0
    st0 = clone_state(pre)
    st0.avoid.fill_(-1)
    res0, new0 = _resident_tick_impl(
        pk, st0, placement="sinkhorn",
        sinkhorn_potentials=(res_k.sinkhorn_f, res_k.sinkhorn_g),
        **dict(kw, KP=T))
    ok = res0.placed_slots >= 0
    a0 = torch.full((T,), -1, dtype=torch.int32, device=packet.device)
    a0[res0.placed_slots[ok].long()] = res0.placed_rows[ok]
    free = new0.free + torch.bincount(
        res0.placed_rows[ok].long(), minlength=kw["W"]).to(torch.int32)
    a1 = hedge_fixup_impl(a0, avoid, new0.speed, free, res0.live)
    vetoed = (avoid >= 0) & (a0 == avoid)
    return int((a1 >= 0).sum()), int((vetoed & (a1 < 0)).sum())


def sinkhorn_check(pre, packet, res_k, new_k, kw: dict, label: str) -> dict:
    """One Sinkhorn launch from its pre-state against the contract:
    (a) exact on every output and state leaf that placement does not
    decide, the count placed and the effective temperature; (b) potentials
    within SINKHORN_TOL of the plain version's; (c) the plain version's
    rounding from the kernel's own potentials reproduces every output and
    state leaf exactly; (d) legal. Also whether the placements differ from
    the plain version's own (reported, not failed)."""
    from tpu_faas_torch.sched.resident import _resident_tick_impl

    res_p, new_p = _resident_tick_impl(packet, clone_state(pre),
                                       placement="sinkhorn", **kw)
    res_r, new_r = _resident_tick_impl(
        packet, clone_state(pre), placement="sinkhorn",
        sinkhorn_potentials=(res_k.sinkhorn_f, res_k.sinkhorn_g), **kw)
    bad = []
    differs = not (torch.equal(res_k.placed_slots, res_p.placed_slots)
                   and torch.equal(res_k.placed_rows, res_p.placed_rows))
    for f in ("arrival_slots", "redispatch_slots", "purged", "live",
              "n_pending", "straggler_slots", "sinkhorn_tau",
              "tenant_eligible"):
        a, b = getattr(res_k, f), getattr(res_p, f)
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            bad.append(f"(a) {f}")
    if int((res_k.placed_slots >= 0).sum()) != int(
            (res_p.placed_slots >= 0).sum()):
        bad.append("(a) placed count")
    # the deficit carry follows the per-tenant placements: exact in (a)
    # whenever they are the plain version's own, and always in (c)
    decided = ("valid", "free") + (("t_deficit",) if differs else ())
    for f in new_k._fields:
        if f not in decided and not same(getattr(new_k, f),
                                         getattr(new_p, f)):
            bad.append(f"(a) state.{f}")
    tau = float(res_k.sinkhorn_tau)
    df = potential_err(res_k.sinkhorn_f, res_p.sinkhorn_f, tau)
    dg = potential_err(res_k.sinkhorn_g, res_p.sinkhorn_g, tau)
    if not (df <= SINKHORN_TOL and dg <= SINKHORN_TOL):
        bad.append(f"(b) potentials: |df|/tau {df:.3e}, |dg|/tau {dg:.3e}")
    b1, _ = compare(res_k, res_r, f"{label} replay: out")
    b2, _ = compare(new_k, new_r, f"{label} replay: state")
    if b1 + b2:
        bad.append(f"(c) {b1 + b2} fields of the replay")
    counts = (spec_fixup_counts(pre, packet, res_k, new_p.avoid, kw)
              if kw.get("use_spec") else None)
    bad += [f"(d) {x}" for x in sinkhorn_legal(pre, res_k, new_k,
                                                kw["max_slots"], kw["KP"],
                                                counts)]
    for x in bad:
        log(f"  MISMATCH {label}: {x}")
    pot = torch.cat([res_k.sinkhorn_f, res_k.sinkhorn_g])
    scale = float(pot[torch.isfinite(pot)].abs().max()) / tau
    return {"bad": len(bad), "df": df, "dg": dg, "differs": int(differs),
            "placed": int((res_k.placed_slots >= 0).sum()), "scale": scale}


def replay_sinkhorn(rs) -> dict:
    """The last resident tick's launches, each from its own pre-state: an
    overflow flush exactly against the plain flush, the Sinkhorn tick
    against the contract (``sinkhorn_check``)."""
    from tpu_faas_torch.sched.resident import _flush_kernel_impl

    kw = dict(rs._statics(), KP=rs.KP, KR=rs.KR, max_slots=rs.max_slots)
    out = {"bad": 0, "df": 0.0, "dg": 0.0, "differs": 0, "scale": 0.0}
    n = len(rs.launch_log)
    for i, (pkt, flush, pre, res) in enumerate(rs.launch_log):
        packet = torch.from_numpy(pkt).to(rs.device)
        post = rs.launch_log[i + 1][2] if i + 1 < n else rs._r_state
        if flush:
            st, arr = _flush_kernel_impl(packet, clone_state(pre),
                                         **rs._statics())
            b, _ = compare(post, st, "flush-state")
            out["bad"] += b + (0 if torch.equal(arr, res[1]) else 1)
            continue
        c = sinkhorn_check(pre, packet, res[0], post, kw, "loop tick")
        out["bad"] += c["bad"]
        out["differs"] += c["differs"]
        out["df"] = max(out["df"], c["df"])
        out["dg"] = max(out["dg"], c["dg"])
        out["scale"] = max(out["scale"], c["scale"])
    return out


def check_math(dev) -> int:
    """expf and logf as the Sinkhorn branch compiles them, bit for bit
    against torch.exp and torch.log on the card, over 2^22 values: lognormal
    sizes and the ranges the iterations take (-cost/tau in [-40, 0], shifts
    around 0). Returns the values that differ."""
    from tpu_faas_torch.sched.fused_tick import KERNEL

    rng = np.random.default_rng(11)
    n = 1 << 20
    x = np.concatenate([
        rng.lognormal(0.0, 3.0, n), rng.uniform(-40.0, 0.0, n),
        rng.uniform(-1.0, 1.0, n), rng.uniform(1e-30, 60_000.0, n),
    ]).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    e, lg = KERNEL.math_probe(xt)
    want_e, want_l = torch.exp(xt), torch.log(xt)
    same_e = (e == want_e) | (torch.isnan(e) & torch.isnan(want_e))
    same_l = (lg == want_l) | (torch.isnan(lg) & torch.isnan(want_l))
    bad = int((~same_e).sum()) + int((~same_l).sum())
    log(f"  expf/logf of the kernel against torch.exp/torch.log on the card: "
        f"{x.size} values each, {bad} differ")
    return bad


def phase_sinkhorn_kernel(dev, probe) -> dict:
    """B1's Sinkhorn branch against its plain version under the contract:
    synthetic headline states (bucketed route, priority lanes on and off,
    two seeds) and one dense-route state at 4,096 x 4,096; and the
    kernel's expf/logf against torch's."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import state_from_numpy

    bad = check_math(dev)
    out = {"df": 0.0, "dg": 0.0, "differs": 0, "cases": 0}
    cases = [(SHAPE, prio, seed) for prio in (False, True) for seed in (0, 1)]
    cases.append((DENSE_SHAPE, False, 5))
    # a -inf speed on a live row with free slots and a -inf size on a valid
    # task sort among the invalid ones in rank placement, so the close's
    # spill takes rank placement's own sorts; on row 0 and task 0 they sort
    # first among those, so the placements stay legal (contract (d))
    cases.append((SHAPE, False, 6))
    for shape, use_priority, seed in cases:
        leaves, pkt = random_case(np.random.default_rng(seed), use_priority,
                                  now=100.0, shape=shape)
        if seed == 6:
            leaves["valid"][0], leaves["sizes"][0] = True, -np.inf
            leaves["speed"][0], leaves["free"][0] = -np.inf, 3
            leaves["active"][0], leaves["last_hb"][0] = True, 99.0
            # the packet's row lanes leave row 0 alone (index W: dropped)
            off = 9 + shape["KA"]
            for K, n in ((shape["KH"], pkt[2]), (shape["KF"], pkt[3]),
                         (shape["KI"], 0), (shape["KS"], pkt[5]),
                         (shape["KB"], pkt[6])):
                lane = pkt[off : off + int(n)]
                lane[lane == 0] = shape["W"]
                off += 2 * K
        kw = dict(shape, max_slots=MAX_SLOTS, use_priority=use_priority)
        pre = state_from_numpy(leaves, dev)
        packet = torch.from_numpy(pkt).to(dev)
        st = clone_state(pre)
        ptrs = [t.data_ptr() for t in st]
        res_k, new_k = KERNEL.sinkhorn(packet, st, **kw)
        torch.cuda.synchronize()
        assert [t.data_ptr() for t in new_k] == ptrs, "state moved"
        route = "dense" if shape is DENSE_SHAPE else "bucketed"
        label = f"{route} {shape['T']}x{shape['W']} prio={use_priority} " \
                f"seed={seed}" + (", a -inf size and speed" if seed == 6
                                  else "")
        phases = KERNEL.sinkhorn_phase_ms(dev, shape["T"], shape["W"],
                                          MAX_SLOTS)
        c = sinkhorn_check(pre, packet, res_k, new_k, kw, label)
        log(f"  {label}: placed {c['placed']}, |df|/tau {c['df']:.3e}, "
            f"|dg|/tau {c['dg']:.3e}, tau {float(res_k.sinkhorn_tau):.6g}, "
            f"largest |f|/tau or |g|/tau {c['scale']:.3f}, "
            f"contract violations {c['bad']}, placements "
            f"{'differ from' if c['differs'] else 'equal'} the plain "
            f"version's; phases {phase_text(phases)}")
        if shape is DENSE_SHAPE or seed in (0, 6):
            sp, b = sinkhorn_probe(dev, probe, packet, pre, kw)
            log(f"    split (probe build): {sinkhorn_split_text(sp)}; probe "
                f"fields differing from the kernel proper's {b}")
            bad += b
            if seed == 6 and not sp["rank_spill"]:
                log("  MISMATCH: the -inf state's spill kept its compacted "
                    "sorts")
                bad += 1
        bad += c["bad"]
        out["differs"] += c["differs"]
        out["df"] = max(out["df"], c["df"])
        out["dg"] = max(out["dg"], c["dg"])
        out["cases"] += 1
    if bad:
        raise SystemExit(f"the Sinkhorn kernel breaks its contract: {bad} "
                         f"violations")
    log(f"phase sinkhorn kernel: {out['cases']} ticks within the contract, "
        f"{out['differs']} placed otherwise than the plain version's own "
        f"potentials")
    out["mismatches"] = bad
    return out


def phase_sinkhorn_batch(dev) -> dict:
    """SchedulerArrays(placement="sinkhorn") on the card at BASELINE config
    4 (tpu_faas/bench/configs.py:296): seed 4, 50,000 lognormal tasks on
    4,000 workers with 1-8 free slots, padded to 51,200 x 4,096 — the
    batch tick's route (bucketed, 20 iterations, bucket rounding) — and
    config 4's own solve on the same inputs (bucketed, 60 iterations, exact
    rounding); each placement's makespan over the LP bound of its placed
    subset (BASELINE's target: 1.05), beside the host greedy's."""
    from tpu_faas_torch.sched.greedy import host_greedy_reference, makespan
    from tpu_faas_torch.sched.oracle import makespan_lower_bound
    from tpu_faas_torch.sched.sinkhorn import sinkhorn_placement_bucketed_impl
    from tpu_faas_torch.sched.state import SchedulerArrays

    rng = np.random.default_rng(4)
    n_tasks, n_workers, K = 50_000, 4_000, MAX_SLOTS
    T, W = SHAPE["T"], SHAPE["W"]
    sizes = rng.lognormal(0.0, 1.0, n_tasks).astype(np.float32)
    speeds = rng.uniform(0.5, 4.0, n_workers).astype(np.float32)
    free = rng.integers(1, K + 1, n_workers).astype(np.int32)
    live = np.ones(n_workers, dtype=bool)
    sa = SchedulerArrays(max_workers=W, max_pending=T, max_inflight=4096,
                         max_slots=K, clock=lambda: 1000.0,
                         placement="sinkhorn", device=dev)
    for i in range(n_workers):
        sa.register(b"w%d" % i, int(free[i]), speed=float(speeds[i]))

    def ratio(a):
        placed = a >= 0
        lb = makespan_lower_bound(sizes[placed], speeds, free, live, K)
        return makespan(a, sizes, speeds, K) / lb

    t0 = time.perf_counter()
    tick = sa.tick(sizes).assignment.cpu().numpy()[:n_tasks]
    wall_ms = (time.perf_counter() - t0) * 1e3
    padded = [torch.zeros(T, device=dev), torch.zeros(T, dtype=torch.bool,
                                                      device=dev),
              torch.zeros(W, device=dev),
              torch.zeros(W, dtype=torch.int32, device=dev),
              torch.zeros(W, dtype=torch.bool, device=dev)]
    for t, host in zip(padded, (sizes, np.ones(n_tasks, bool), speeds, free,
                                live)):
        t[: len(host)] = torch.from_numpy(host).to(dev)
    solve = sinkhorn_placement_bucketed_impl(
        *padded, tau=0.05, n_iters=60, max_slots=K,
    ).assignment.cpu().numpy()[:n_tasks]
    greedy = host_greedy_reference(sizes, speeds, np.minimum(free, K), live)
    cap = int(np.minimum(free, K).sum())
    for name, a in (("batch tick", tick), ("config 4 solve", solve)):
        check_assignment(a, np.ones(n_tasks, bool), np.minimum(free, K), live)
        assert int((a >= 0).sum()) == min(n_tasks, cap), name
    out = {"tick": ratio(tick), "solve": ratio(solve),
           "greedy": ratio(greedy), "wall_ms": wall_ms,
           "lb": makespan_lower_bound(sizes[tick >= 0], speeds, free, live,
                                      K)}
    log(f"phase sinkhorn batch (config 4: 50,000 tasks, 4,000 workers, "
        f"{cap} slots): makespan / LP bound {out['tick']:.4f} for the batch "
        f"tick (bucketed, 20 iterations, bucket rounding; first tick "
        f"{wall_ms:.1f} ms with the read back), {out['solve']:.4f} for "
        f"config 4's solve (60 iterations, exact rounding), host greedy "
        f"{out['greedy']:.4f}; the bound on the batch tick's subset "
        f"{out['lb']:.4f} s")
    return out


SINKHORN_PHASES = ("packet+liveness", "reductions", "setup", "iterations",
                   "candidates", "repair+spill", "compaction")


def phase_text(ms: list[float]) -> str:
    return ", ".join(f"{n} {t:.4f} ms" for n, t in zip(SINKHORN_PHASES, ms))


#: a logsumexp cell's work, counted from the plain expression (sinkhorn.py:
#: ``_logsumexp(negc + g/tau)``) with its row and column factors hoisted
#: out of the cell: the cell (one fma), the max, the shift, the exp and
#: the sum: 5 issue slots, one of them the exp on the SFU. The count does
#: not move with the kernel's code.
SK_CELL_ISSUE, SK_CELL_SFU = 5, 1


def sinkhorn_pipes_ms(clock_hz: float) -> dict:
    """The headline iterations' least time on each pipe: 2 x 20 x 1,025 x
    4,097 cells (one per cell of the [R, C] problem for f and for g in each
    of 20 iterations), their exps at the SFU's 16 a clock per SM and their
    issue slots at the schedulers' 128, on every SM at ``clock_hz``."""
    from tpu_faas_torch.sched.state import BUCKETED_ITERS, N_BUCKETS

    R, C = N_BUCKETS + 1, SHAPE["W"] + 1
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cells = 2 * BUCKETED_ITERS * R * C
    per_s = n_sm * clock_hz / 1e3
    return {"cells": cells,
            "SFU": cells * SK_CELL_SFU / SFU_PER_SM_CLOCK / per_s,
            "issue": cells * SK_CELL_ISSUE / ISSUE_PER_SM_CLOCK / per_s}


def sinkhorn_bound_ms(packet: torch.Tensor, clock_hz: float) -> tuple[
        float, str]:
    """The least time for one headline Sinkhorn tick: the larger of the
    iterations' operations on the pipe that binds (``sinkhorn_pipes_ms``)
    and the rank tick's bytes plus the potentials written."""
    from tpu_faas_torch.sched.state import N_BUCKETS

    R, C = N_BUCKETS + 1, SHAPE["W"] + 1
    pipes = sinkhorn_pipes_ms(clock_hz)
    ops_ms = max(pipes["SFU"], pipes["issue"])
    bytes_ms = bound_ms(False, packet) + 4 * (R + C + 1) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def sinkhorn_library_ms(dev, samples: list) -> float:
    """The iterations' library yardstick (context only; the port never
    calls it): 20 iterations of torch.logsumexp over the materialized
    [1,025, 4,097] matrix of -cost/tau (16.8 MB), plus g/tau by rows and
    f/tau by columns, on the loop's first state; CUDA-event mean of one
    tick's 40 calls."""
    from tpu_faas_torch.sched.state import BUCKETED_ITERS, N_BUCKETS

    st = samples[0][1]
    R, C = N_BUCKETS + 1, SHAPE["W"] + 1
    rng = np.random.default_rng(3)
    rep = torch.exp(torch.linspace(-3.0, 3.0, R - 1, device=dev))
    inv = 1.0 / st.speed.clamp_min(1e-6)
    tau = float(0.05 * rep.max() * inv.max())
    negc = torch.full((R, C), float("-inf"), device=dev)
    negc[:-1, :-1] = -(rep[:, None] * inv[None, :]) / tau
    negc[:-1, -1] = -(float(rep.max() * inv.max()) + 1.0) / tau
    negc[-1, :-1] = 0.0
    g = torch.from_numpy(rng.uniform(-5, 5, C).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.uniform(-5, 5, R).astype(np.float32)).to(dev)

    def iterations(_):
        for _ in range(BUCKETED_ITERS):
            torch.logsumexp(negc + g[None, :], dim=1)
            torch.logsumexp(negc + f[:, None], dim=0)

    return statistics.mean(event_ms(iterations, 10))


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def time_resident_sinkhorn(dev, samples: list, probe) -> dict:
    """The Sinkhorn kernel per tick on the resident Sinkhorn loop's own
    states (CUDA-event means), beside its bound and its plain version on
    the card, with the plain bucketed 20-iteration solve alone as
    context."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import _resident_tick_impl
    from tpu_faas_torch.sched.sinkhorn import sinkhorn_placement_bucketed_impl

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    n = len(samples)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % n]
        return packet, clone_state(pre)

    k_ms = event_ms(lambda a: KERNEL.sinkhorn(a[0], a[1], **kw), n,
                    setup=next_sample)
    p_ms = event_ms(lambda a: _resident_tick_impl(
        a[0], a[1], placement="sinkhorn", **kw), n, setup=next_sample)

    def solve(a):
        st = a[1]
        sinkhorn_placement_bucketed_impl(
            st.sizes, st.valid, st.speed, st.free, st.active,
            max_slots=MAX_SLOTS, n_iters=20, rounding="bucket")

    s_ms = event_ms(solve, n, setup=next_sample)
    # the split: block 0's clock at each phase of one launch per state, and
    # a grid barrier alone on the same grid
    phases = []
    for packet, pre, _ in samples:
        KERNEL.sinkhorn(packet, clone_state(pre), **kw)
        phases.append(KERNEL.sinkhorn_phase_ms(dev, SHAPE["T"], SHAPE["W"],
                                               MAX_SLOTS))
    split = [statistics.mean(p[i] for p in phases)
             for i in range(len(SINKHORN_PHASES))]
    n_bar = 400
    bar0 = statistics.median(event_ms(lambda _: KERNEL.barrier_probe(0), 10))
    bar1 = statistics.median(event_ms(lambda _: KERNEL.barrier_probe(n_bar),
                                      10))
    per_barrier = (bar1 - bar0) / n_bar
    clock = sm_clock_hz()
    bounds = [sinkhorn_bound_ms(p.cpu(), clock) for p, _, _ in samples]
    pipes = sinkhorn_pipes_ms(clock)
    lib_ms = sinkhorn_library_ms(dev, samples)
    out = {"ms": statistics.mean(k_ms), "plain_ms": statistics.mean(p_ms),
           "solve_ms": statistics.mean(s_ms), "split": split,
           "barrier_ms": per_barrier,
           "bound_ms": statistics.mean(b for b, _ in bounds),
           "bound_by": statistics.mode(by for _, by in bounds),
           "pipes": pipes, "library_iters_ms": lib_ms}
    pipe = max(("SFU", "issue"), key=pipes.get)
    log(f"  Sinkhorn kernel on the resident Sinkhorn run's {n} states, "
        f"means: {out['ms']:.4f} ms (min {min(k_ms):.4f}, max "
        f"{max(k_ms):.4f}); bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}, the {pipe} pipe: {pipes['cells']} cells "
        f"(2 x 20 x 1,025 x 4,097), one exp each at {SFU_PER_SM_CLOCK} per "
        f"SM per clock {pipes['SFU']:.4f} ms, {SK_CELL_ISSUE} issue slots "
        f"each at {ISSUE_PER_SM_CLOCK} {pipes['issue']:.4f} ms; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs "
        f"at {clock / 1e9:.3f} GHz), kernel/bound "
        f"{out['ms'] / out['bound_ms']:.1f}; plain version "
        f"{out['plain_ms']:.4f} ms; the plain bucketed 20-iteration solve "
        f"alone {out['solve_ms']:.4f} ms; the iterations' library "
        f"yardstick, 40 torch.logsumexp calls over the materialized "
        f"[1,025, 4,097] matrix: {lib_ms:.4f} ms")
    log(f"  its split (block 0's clock, means over the {n} states): "
        f"{phase_text(split)}; a grid barrier alone {per_barrier * 1e3:.3f} "
        f"us, so the iterations' 40 barriers {40 * per_barrier:.4f} ms and "
        f"their compute {split[3] - 40 * per_barrier:.4f} ms")
    out.update(resident_sinkhorn_split(dev, probe, samples))
    return out


def sinkhorn_probe(dev, probe, packet, pre, kw: dict) -> tuple[dict, int]:
    """One launch of the probe build from ``pre`` (left untouched), beside
    one of the kernel proper: (the probe's split, fields that differ
    between the two launches, potentials included)."""
    from tpu_faas_torch.sched.fused_tick import KERNEL

    res_k, st_k = KERNEL.sinkhorn(packet, clone_state(pre), **kw)
    res_p, st_p = probe.sinkhorn(packet, clone_state(pre), **kw)
    sp = probe.sinkhorn_split(dev, kw["T"], kw["W"], kw["max_slots"])
    b1, _ = compare(res_p, res_k, "probe build: out")
    b2, _ = compare(st_p, st_k, "probe build: state")
    return sp, b1 + b2


def sinkhorn_split_text(sp: dict) -> str:
    """A probe split with its iterations summed."""
    f, fb, g, gb = (sum(it[i] for it in sp["iters"]) for i in range(4))
    c = sp["close"]
    return (f"{len(sp['iters'])} iterations: f-updates {f:.4f} ms, their "
            f"barriers {fb:.4f} ms, g-updates {g:.4f} ms, their barriers "
            f"{gb:.4f} ms; close {c['total']:.4f} ms: candidates' keys "
            f"{c['keys']:.4f}, sorts {c['sort1']:.4f} + {c['sort2']:.4f}, "
            f"repair {c['repair']:.4f}, spill admission and slot sort "
            f"{c['slots']:.4f}, spill task sort and pairs {c['spill']:.4f} "
            f"ms; candidates {sp['candidates']}, "
            f"spilled {sp['spilled']}, spilled pairs placed {sp['pairs']}"
            + ("; the spill took rank placement's own sorts"
               if sp["rank_spill"] else ""))


def resident_sinkhorn_split(dev, probe, samples: list) -> dict:
    """The probe build's split on the resident Sinkhorn loop's own states,
    each launch beside the kernel proper's (exactly equal), and its means
    over them."""
    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False)
    splits, bad = [], 0
    for i, (packet, pre, _) in enumerate(samples):
        sp, b = sinkhorn_probe(dev, probe, packet, pre, kw)
        bad += b
        splits.append(sp)
        log(f"  state {i}: {sinkhorn_split_text(sp)}")
    mean = {k: statistics.mean(sum(it[i] for it in sp["iters"])
                               for sp in splits)
            for i, k in enumerate(("f_ms", "f_bar_ms", "g_ms", "g_bar_ms"))}
    for k in ("keys", "sort1", "sort2", "repair", "slots", "spill", "total"):
        mean["close_" + k] = statistics.mean(sp["close"][k] for sp in splits)
    for k in ("candidates", "spilled", "pairs"):
        mean[k] = statistics.mean(sp[k] for sp in splits)
    log(f"  split means over the {len(splits)} states (probe build, block "
        f"0's clock): f-updates {mean['f_ms']:.4f} ms, barriers "
        f"{mean['f_bar_ms']:.4f} ms, g-updates {mean['g_ms']:.4f} ms, "
        f"barriers {mean['g_bar_ms']:.4f} ms; close {mean['close_total']:.4f}"
        f" ms (candidates' keys {mean['close_keys']:.4f}, sorts "
        f"{mean['close_sort1']:.4f} + {mean['close_sort2']:.4f}, repair "
        f"{mean['close_repair']:.4f}, spill admission and slot sort "
        f"{mean['close_slots']:.4f}, spill task sort and pairs "
        f"{mean['close_spill']:.4f}); "
        f"candidates {mean['candidates']:.1f}, spilled {mean['spilled']:.1f},"
        f" spilled pairs placed {mean['pairs']:.1f} a tick; probe launches "
        f"differing from the kernel proper's: {bad} fields")
    if bad:
        raise SystemExit(f"the Sinkhorn probe build differs from the kernel "
                         f"proper: {bad} fields")
    return {"split_means": mean}


# -- phase 9: times -----------------------------------------------------------
def event_ms(fn, n: int, setup=None) -> list[float]:
    """Per-call device time of ``fn`` with CUDA events, ``n`` calls after a
    warm-up; ``setup`` runs before each call, outside the timed pair. A spin
    kernel queued ahead of each call keeps the card busy while the host
    enqueues it, so the pair brackets device work and not the launch gap."""
    times = []
    for i in range(n + 3):
        torch.cuda._sleep(SPIN_CYCLES)
        arg = setup() if setup else None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(arg)
        b.record()
        if i >= 3:
            times.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in times]


def bound_ms(use_priority: bool, packet: torch.Tensor) -> float:
    """Least time for one tick's bytes at HBM rate, for this packet. Reads:
    the packet's header and used lanes, and each state leaf the tick reads,
    once. Writes: valid, free and prev_live in full (any entry may change);
    sizes and prio at the arrivals, last_hb, inflight, speed and active at
    this packet's counts (scatters); and the compacted outputs (the
    straggler output is its length-1 pad: the speculation lane's own bytes
    are ``spec_bound_ms``)."""
    S = SHAPE
    T, W, I = S["T"], S["W"], S["I"]
    n_arr, n_hb, n_fr, n_if, n_sp, n_ac = (int(x) for x in packet[1:7])
    lanes = 2 if use_priority else 1
    pkt = 4 * (9 + n_arr * lanes + 2 * (n_hb + n_fr + n_if + n_sp + n_ac))
    reads = T * (4 + 1 + 4 * (lanes - 1)) + W * (4 + 4 + 1 + 4 + 1) + I * 4
    writes = (T + W * (4 + 1) + 4 * n_arr * lanes
              + 4 * (n_hb + n_if + n_sp) + n_ac)
    outs = 4 * (2 * S["KP"] + S["KA"] + S["KR"] + 1 + 1) + 2 * W
    return (pkt + reads + writes + outs) / HBM_BYTES_PER_S * 1e3


def rank_split_text(sp: dict) -> str:
    from tpu_faas_torch.sched.fused_tick import RANK_COUNTS, RANK_PHASES

    return (" + ".join(f"{k} {sp[k]:.4f}" for k in RANK_PHASES)
            + f" = {sp['total']:.4f} ms; "
            + ", ".join(f"{k} {sp[k]}" for k in RANK_COUNTS))


def resident_rank_split(dev, probe, samples: list, kw: dict,
                        label: str) -> dict:
    """The rank branch's split on a resident loop's own states: one launch
    of the probe build each, beside one of the kernel proper (every output
    and state leaf equal); the phases' means over the states."""
    from tpu_faas_torch.sched.fused_tick import (
        KERNEL, RANK_COUNTS, RANK_PHASES,
    )

    splits, bad = [], 0
    for packet, pre, _ in samples:
        res_k, st_k = KERNEL(packet, clone_state(pre), flush=False, **kw)
        res_p, st_p = probe(packet, clone_state(pre), flush=False, **kw)
        splits.append(probe.rank_split(dev, SHAPE["T"], SHAPE["W"],
                                       MAX_SLOTS))
        b1, _ = compare(res_p, res_k, "probe build: out")
        b2, _ = compare(st_p, st_k, "probe build: state")
        bad += b1 + b2
    mean = {k: statistics.mean(sp[k] for sp in splits)
            for k in (*RANK_PHASES, "total", *RANK_COUNTS)}
    log(f"  rank split, {label} (probe build, means over {len(splits)} "
        f"states): {rank_split_text(mean)}")
    if bad:
        raise SystemExit(f"rank probe build differs from the kernel: {bad} "
                         f"mismatched fields")
    return mean


def phase_time(dev, n: int, samples: list, probe) -> dict:
    """Kernel and plain-version times; ``samples`` are the resident run's
    own (packet, input state) pairs from its last steady ticks."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _resident_tick_impl, state_from_numpy,
    )
    from tpu_faas_torch.sched.state import SchedulerArrays

    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % len(samples)]
        return packet, clone_state(pre)

    loop_ms = event_ms(lambda a: KERNEL(a[0], a[1], flush=False, **kw),
                       len(samples), setup=next_sample)
    loop_bound = statistics.median(bound_ms(True, p.cpu())
                                   for p, _, _ in samples)
    out = {"loop": (statistics.median(loop_ms), loop_bound)}
    log(f"  kernel on the resident run's own states (prio=True): "
        f"{out['loop'][0]:.4f} ms (min {min(loop_ms):.4f}), bound "
        f"{loop_bound:.6f} ms, medians of {len(loop_ms)}")
    out["split"] = resident_rank_split(dev, probe, samples, kw,
                                       "the resident loop's states")
    for use_priority in (True, False):
        leaves, pkt = random_case(np.random.default_rng(3), use_priority,
                                  now=100.0)
        base = state_from_numpy(leaves, dev)
        packet = torch.from_numpy(pkt).to(dev)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority)
        k_ms = event_ms(lambda st: KERNEL(packet, st, flush=False, **kw), n,
                        setup=lambda: clone_state(base))
        p_ms = event_ms(lambda _: _resident_tick_impl(packet, base, **kw), n)
        bound = bound_ms(use_priority, torch.from_numpy(pkt))
        out[use_priority] = (statistics.median(k_ms),
                             statistics.median(p_ms), bound)
        log(f"  synthetic state, prio={use_priority}: kernel "
            f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}), plain "
            f"version on the card {statistics.median(p_ms):.4f} ms, bound "
            f"{bound:.6f} ms, medians of {n}")
    # the batch tick (SchedulerArrays.tick) at the same shape
    rng = np.random.default_rng(4)
    sa = SchedulerArrays(max_workers=SHAPE["W"], max_pending=SHAPE["T"],
                         max_inflight=SHAPE["I"], max_slots=MAX_SLOTS,
                         clock=lambda: 1000.0, device=dev)
    for i in range(SHAPE["W"]):
        sa.register(b"w%d" % i, int(rng.integers(1, 9)),
                    speed=float(rng.uniform(0.5, 4.0)))
    for i in range(16_384):
        sa.inflight_add(f"t{i}", int(rng.integers(0, SHAPE["W"])))
    batch = rng.uniform(0.1, 10.0, 50_000).astype(np.float32)
    walls = []
    for i in range(n + 3):
        t0 = time.perf_counter()
        o = sa.tick(batch)
        o.assignment[:1].cpu()
        if i >= 3:
            walls.append((time.perf_counter() - t0) * 1e3)
    out["batch_ms"] = statistics.median(walls)
    log(f"  batch tick (SchedulerArrays.tick, 50,000 tasks, readback of "
        f"one value): {out['batch_ms']:.4f} ms median of {n}")
    return out


def time_bid(dev, n: int) -> dict:
    """B2 and its plain version at config 7's and config 3's shapes, each
    beside its bound."""
    from tpu_faas_torch.sched.bid import KERNEL, bid_top2_stream_impl

    out = {}
    clock = sm_clock_hz()
    for name, (T, S), seed in (("headline", BID_HEADLINE, 7),
                               ("config3", BID_CONFIG3, 33)):
        args = bid_inputs(dev, T, S, seed)
        js = float(np.float32(1e-4))
        k_ms = event_ms(lambda _: KERNEL(*args, js), n)
        p_ms = event_ms(lambda _: bid_top2_stream_impl(*args, js),
                        max(3, n // 10))
        bound, by = bid_bound_ms(T, S, clock)
        out[name] = (statistics.median(k_ms), statistics.median(p_ms),
                     bound, by)
        log(f"  bid_top2 {T} x {S}: kernel {out[name][0]:.4f} ms (min "
            f"{min(k_ms):.4f}), plain version on the card "
            f"{out[name][1]:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{bid_pipe_text(clock)}), kernel/bound "
            f"{out[name][0] / bound:.2f}, the kernel at "
            f"{100 * bound / out[name][0]:.1f}% of its bound")
    return out


def time_auction(auction: dict, reps: int) -> dict:
    """Host-clock medians of the integrated auction tick (upload, solve,
    one value read back), cold (carried prices dropped) and warm."""
    out = {}
    for name, (sa, batches) in auction["arrays"].items():
        for mode in ("cold", "warm"):
            walls, rounds = [], []
            for i in range(reps):
                if mode == "cold":
                    sa._d_auction_price = None
                t0 = time.perf_counter()
                o = sa.tick(batches[i % len(batches)])
                o.assignment[:1].cpu()
                walls.append((time.perf_counter() - t0) * 1e3)
                rounds.append(o.auction_rounds)
            out[(name, mode)] = statistics.median(walls)
            log(f"  auction tick, {name}, {mode}: "
                f"{out[(name, mode)]:.3f} ms median of {reps}, rounds "
                f"{rounds}")
    return out


# -- phase 8: the tenancy lane (B1 with use_tenancy, all three branches) ----
def tenant_table(total_slots: int):
    """Config 16's tenancy (tpu_faas/bench/configs.py:2840): shares
    light=8, heavy=1, heavy capped at the fleet's slots minus one; four more
    tenants capped at 8, 64, 512 and 2,048 in flight, and the rest of the
    32 rows registered uncapped at share 1. Rows: 0 default, 1 light,
    2 heavy, 3.. the others."""
    from tpu_faas_torch.tenancy import TenantTable

    ten = TenantTable(max_tenants=NT_HEADLINE)
    ten.apply_specs("light=8,heavy=1",
                    f"heavy={total_slots - 1},t3=8,t4=64,t5=512,t6=2048")
    for i in range(7, NT_HEADLINE):
        ten.row_for(f"t{i}")
    assert (ten.row_for("light"), ten.row_for("heavy")) == (1, 2)
    assert ten.n_tenants == NT_HEADLINE
    return ten


def with_tenancy(leaves: dict, pkt: np.ndarray, rng, use_priority: bool,
                 NT: int = NT_HEADLINE):
    """``random_case``'s state and packet with the tenancy lane at ``NT``
    rows (NT_HEADLINE by default): tenant rows in the state over every row
    and past both ends; deficits on both sides of the starvation threshold
    (1,024) and at the cap (4,096); in the arrival lane rows past both
    ends, a NaN, a saturating and two truncating values; caps of 0
    (uncapped), at ``ahead``, below it and above it."""
    T, KA = SHAPE["T"], SHAPE["KA"]
    f32 = np.float32
    leaves = dict(
        leaves, tenant=rng.integers(-2, NT + 2, T).astype(np.int32),
        t_deficit=rng.choice(np.array([0.0, 5.5, 1023.75, 1024.0, 1500.0,
                                       4096.0], f32), NT))
    arr = rng.integers(-3, NT + 3, KA).astype(f32)
    arr[:5] = [1e10, -1e10, np.nan, 2.7, -0.5]
    share = rng.choice(np.array([8.0, 1.0, 2.0, 0.5, 3.0], f32), NT)
    ahead = rng.integers(0, 2000, NT)
    # half the rows uncapped, then at ahead, below it and above it: more
    # tasks eligible than the fleet has slots, so the admission order
    # decides which are placed
    kind = np.minimum(np.arange(NT) % 8, 4)
    cap = np.select(
        [kind <= 1, kind == 2, kind == 3],
        [0, ahead, np.maximum(ahead - rng.integers(1, 500, NT), 1)],
        ahead + rng.integers(1, 1200, NT))
    cut = 9 + KA * (2 if use_priority else 1)
    pkt = np.concatenate([pkt[:cut], arr, pkt[cut:], share, ahead,
                          cap]).astype(f32)
    return leaves, pkt


def tenancy_violations(res, tenant_leaf: torch.Tensor, pkt,
                       NT: int = NT_HEADLINE) -> int:
    """Tenants one launch placed past their allowance (cap minus inflight
    off the packet's tail, for the capped ones), plus placed tasks outside
    the launch's eligibility mask."""
    tail = np.asarray(pkt, np.float32)[-3 * NT:].astype(np.int64)
    ahead, cap = tail[NT : 2 * NT], tail[2 * NT :]
    slots = res.placed_slots[res.placed_slots >= 0].long()
    rows = tenant_leaf[slots].clamp(0, NT - 1).long()
    per = torch.bincount(rows, minlength=NT).cpu().numpy()
    allow = np.where(cap > 0, np.maximum(cap - ahead, 0), np.iinfo(np.int64).max)
    return int((per > allow).sum()) + int((~res.tenant_eligible[slots]).sum())


def tenancy_bound_ms(packet: torch.Tensor) -> float:
    """The lane's own bytes at the HBM rate: the tenant leaf read and the
    eligibility written (T each), the arrivals' tenant lane read and their
    rows written, the deficits read and written and the packet's tail."""
    T, NT = SHAPE["T"], NT_HEADLINE
    n_arr = int(packet[1])
    return (4 * T + T + 8 * n_arr + 8 * NT + 12 * NT) / HBM_BYTES_PER_S * 1e3


def phase_resident_tenancy(dev, card: str, probe) -> dict:
    """B1's tenancy lane in its three branches: against the plain version on
    synthetic headline states (priority lanes off and on); its time with
    the lane on against the same states with it off; then a resident loop
    per branch with config 16's shares and caps (``phase_resident`` with
    ``tenancy=True``), each launch counted with the counts set to 0 just
    before the loop and read just after; and the rank branch with the lane
    on the rank loop's own states, beside its plain version and its bound,
    for the kernels line."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl, state_from_numpy,
    )

    bad = {"rank": 0, "auction": 0, "sinkhorn": 0}
    err = dict.fromkeys(bad, 0.0)  # Sinkhorn: max |dg|/tau (contract b)
    lane = {}  # branch -> (ms with the lane off, ms with it on)
    for use_priority in (False, True):
        rng = np.random.default_rng(20 + int(use_priority))
        base, bpkt = random_case(rng, use_priority, now=100.0)
        leaves, pkt = with_tenancy(base, bpkt, rng, use_priority)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority,
                  **TENANCY_KW)
        packet = torch.from_numpy(pkt).to(dev)
        # rank, and the flush on the same packet
        res_p, new_p = _resident_tick_impl(
            packet, state_from_numpy(leaves, dev), **kw)
        res_k, new_k = KERNEL(packet, state_from_numpy(leaves, dev),
                              flush=False, **kw)
        fkw = {k: v for k, v in kw.items() if k not in ("KP", "KR",
                                                         "max_slots")}
        fst_p, farr_p = _flush_kernel_impl(
            packet, state_from_numpy(leaves, dev), **fkw)
        fst_k, farr_k = KERNEL(packet, state_from_numpy(leaves, dev),
                               flush=True, **kw)
        torch.cuda.synchronize()
        b1, e1 = compare(res_k, res_p, "tenancy rank out")
        b2, e2 = compare(new_k, new_p, "tenancy rank state")
        b3, e3 = compare(fst_k, fst_p, "tenancy flush state")
        b4 = 0 if torch.equal(farr_k, farr_p) else 1
        over = tenancy_violations(res_k, new_k.tenant, pkt)
        b = b1 + b2 + b3 + b4 + over
        bad["rank"] += b
        err["rank"] = max(err["rank"], e1, e2, e3)
        n_elig = int(res_k.tenant_eligible.sum())
        valid = int(leaves["valid"].sum())
        slots = int(torch.where(res_k.live, new_k.free.clamp(0, MAX_SLOTS),
                                0).sum()) + int(SHAPE["KP"])
        assert n_elig > slots, "the admission order decides nothing"
        log(f"  rank prio={use_priority}: eligible {n_elig} of the "
            f"{valid} valid before arrivals, more than the fleet's "
            f"{slots} slots, placed (reported) "
            f"{int((res_k.placed_slots >= 0).sum())}, deficits "
            f"{int((new_k.t_deficit > 0).sum())} of {NT_HEADLINE} positive, "
            f"flush equal {not (b3 + b4)}, mismatched fields and violations "
            f"{b}")
        # the auction, cold from the seed; the plain-bid twin on one state
        aleaves = dict(leaves,
                       price=(rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
                              / 16).astype(np.float32),
                       refresh=np.asarray(True))
        b, e, rounds, spilled, rows = compare_auction_tick(
            dev, aleaves, pkt, use_priority,
            f"tenancy auction prio={use_priority}",
            plain_twin=not use_priority, tenancy=True)
        bad["auction"] += b
        err["auction"] = max(err["auction"], e)
        log(f"  auction prio={use_priority}: rounds {rounds}, spilled "
            f"{spilled}, bidder rows {rows}, mismatched fields and "
            f"violations {b}" + ("; also against plain bids"
                                 if not use_priority else ""))
        # Sinkhorn, under its contract, eligibility and deficits added
        pre = state_from_numpy(leaves, dev)
        res_s, new_s = KERNEL.sinkhorn(packet, clone_state(pre), **kw)
        torch.cuda.synchronize()
        c = sinkhorn_check(pre, packet, res_s, new_s, kw,
                           f"tenancy sinkhorn prio={use_priority}")
        over = tenancy_violations(res_s, new_s.tenant, pkt)
        bad["sinkhorn"] += c["bad"] + over
        err["sinkhorn"] = max(err["sinkhorn"], c["dg"])
        log(f"  sinkhorn prio={use_priority}: placed {c['placed']}, |df|/tau "
            f"{c['df']:.3e}, |dg|/tau {c['dg']:.3e}, contract violations "
            f"{c['bad']}, tenancy violations {over}, placements "
            f"{'differ from' if c['differs'] else 'equal'} the plain "
            f"version's")
        if use_priority:
            continue
        # the lane's cost: the same state with the lane off and on
        off = state_from_numpy(base, dev)
        on = state_from_numpy(leaves, dev)
        off_pkt = torch.from_numpy(bpkt).to(dev)
        kw_off = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=use_priority)
        aoff = state_from_numpy(dict(aleaves, tenant=base["tenant"],
                                     t_deficit=base["t_deficit"]), dev)
        aon = state_from_numpy(aleaves, dev)
        for name, call, n, s_off, s_on in (
            ("rank", lambda p, st, k: KERNEL(p, st, flush=False, **k),
             N_TIMED, off, on),
            ("auction", lambda p, st, k: KERNEL.auction(p, st, **k), 3,
             aoff, aon),
            ("sinkhorn", lambda p, st, k: KERNEL.sinkhorn(p, st, **k), 10,
             off, on),
        ):
            t_off = event_ms(lambda st: call(off_pkt, st, kw_off), n,
                             setup=lambda s0=s_off: clone_state(s0))
            t_on = event_ms(lambda st: call(packet, st, kw), n,
                            setup=lambda s0=s_on: clone_state(s0))
            lane[name] = (statistics.median(t_off), statistics.median(t_on))
            log(f"  {name} kernel on one synthetic state, lane off "
                f"{lane[name][0]:.4f} ms, on {lane[name][1]:.4f} ms "
                f"(+{lane[name][1] - lane[name][0]:.4f} ms), medians of "
                f"{n} [{card}]")
            if name != "rank":
                bad[name] += lane_probe_splits(
                    dev, probe, "tenancy", name, (off_pkt, s_off, kw_off),
                    (packet, s_on, kw))
    # tenant rows past the 1,024 block 0 counts in shared memory: their
    # counts live in global scratch; the rank grid's tiles count every row
    # in global scratch; rank (NT = 1,100 and 4,096) and auction (4,096)
    # exactly equal
    for nt in (NT_MID, NT_WIDE):
        rng = np.random.default_rng(24)
        base, bpkt = random_case(rng, nt == NT_MID, now=100.0)
        leaves, pkt = with_tenancy(base, bpkt, rng, nt == NT_MID, NT=nt)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=nt == NT_MID,
                  use_tenancy=True, NT=nt)
        packet = torch.from_numpy(pkt).to(dev)
        res_p, new_p = _resident_tick_impl(
            packet, state_from_numpy(leaves, dev), **kw)
        res_k, new_k = KERNEL(packet, state_from_numpy(leaves, dev),
                              flush=False, **kw)
        torch.cuda.synchronize()
        b1, e1 = compare(res_k, res_p, f"tenancy NT={nt} rank out")
        b2, e2 = compare(new_k, new_p, f"tenancy NT={nt} rank state")
        over = tenancy_violations(res_k, new_k.tenant, pkt, nt)
        bad["rank"] += b1 + b2 + over
        err["rank"] = max(err["rank"], e1, e2)
        log(f"  NT={nt} tenant rows, prio={nt == NT_MID}: rank placed "
            f"{int((res_k.placed_slots >= 0).sum())}, deficits "
            f"{int((new_k.t_deficit > 0).sum())} of {nt} positive, "
            f"mismatched fields and violations {b1 + b2 + over}")
    aleaves = dict(leaves,
                   price=(rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
                          / 16).astype(np.float32),
                   refresh=np.asarray(True))
    b, e, rounds, spilled, rows = compare_auction_tick(
        dev, aleaves, pkt, False, f"tenancy auction NT={NT_WIDE}",
        plain_twin=False, tenancy=True, nt=NT_WIDE)
    bad["auction"] += b
    err["auction"] = max(err["auction"], e)
    log(f"  NT={NT_WIDE} tenant rows: auction rounds {rounds}, bidder rows "
        f"{rows}, mismatched fields and violations {b}")
    total = sum(bad.values())
    if total:
        raise SystemExit(f"the tenancy lane disagrees with its plain "
                         f"version: {bad}")
    log("phase tenancy kernel: rank and auction ticks and flushes exactly "
        "equal, Sinkhorn within its contract, every tenant within its "
        "allowance")

    loops = {}
    for placement in ("rank", "auction", "sinkhorn"):
        n_checked, n_timed = TENANCY_TICKS[placement]
        KERNEL.launches = KERNEL.auction_launches = 0
        KERNEL.sinkhorn_launches = KERNEL.tenancy_launches = 0
        r = phase_resident(dev, n_checked, n_timed, placement=placement,
                           tenancy=True)
        r["tenancy_launches"] = KERNEL.tenancy_launches
        r["branch_launches"] = {"rank": KERNEL.launches,
                                "auction": KERNEL.auction_launches,
                                "sinkhorn": KERNEL.sinkhorn_launches}
        assert r["tenancy_launches"] > 0, f"{placement}: the lane never ran"
        assert r["branch_launches"][placement] > 0
        bad[placement] += r["mismatches"] + r["over_allowance"]
        err[placement] = max(err[placement], r["max_abs_err"])
        loops[placement] = r
        log(f"  integrated tick_resident with tenancy, {placement} (diff, "
            f"pack, upload, kernel; synchronized): "
            f"{statistics.median(r['tick_ms']):.4f} ms against the 5 ms "
            f"period, host enqueue alone "
            f"{statistics.median(r['tick_enqueue_ms']):.4f} ms, packet "
            f"upload + kernel on the card "
            f"{statistics.median(r['launch_ms']):.4f} ms, medians of "
            f"{len(r['tick_ms'])} ticks; launches with the lane "
            f"{r['tenancy_launches']} [{card}]")

    # the main path's entry: the rank branch with the lane on the rank
    # loop's own states, its plain version on the same states, its bound
    samples = loops["rank"]["samples"]
    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True, **TENANCY_KW)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % len(samples)]
        return packet, clone_state(pre)

    k_ms = event_ms(lambda a: KERNEL(a[0], a[1], flush=False, **kw),
                    len(samples), setup=next_sample)
    p_ms = event_ms(lambda a: _resident_tick_impl(a[0], a[1], **kw),
                    len(samples), setup=next_sample)
    lane_b = statistics.median(tenancy_bound_ms(p.cpu()) for p, _, _ in samples)
    bound = statistics.median(bound_ms(True, p.cpu()) for p, _, _ in samples)
    log(f"  rank kernel with the lane on the tenancy loop's own states: "
        f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}), plain "
        f"version {statistics.median(p_ms):.4f} ms, bound {bound + lane_b:.6f}"
        f" ms (bytes: the rank tick's {bound:.6f} ms plus the lane's own "
        f"{lane_b:.6f} ms), medians of {len(k_ms)} [{card}]")
    resident_rank_split(dev, probe, samples, kw,
                        "the tenancy rank loop's states")
    return {"mismatches": bad, "max_abs_err": err, "lane": lane,
            "loops": loops, "ms": statistics.median(k_ms),
            "plain_ms": statistics.median(p_ms), "bound_ms": bound + lane_b,
            "lane_bound_ms": lane_b,
            "launches": loops["rank"]["tenancy_launches"]}


# -- phase 9: the speculation lane ------------------------------------------
def with_spec(leaves: dict, pkt: np.ndarray, rng, use_priority: bool,
              tenancy: bool, now: float):
    """``random_case``'s state and packet (``with_tenancy``'s with
    ``tenancy``) with the speculation lane: in-flight slots past, about at
    and under their threshold (on live rows, dead rows and empty slots
    alike), with pred 0, negative and NaN; avoid rows of -1, real rows and
    rows past both ends; arrivals' avoid rows likewise, with a NaN, a
    saturating and a truncating value; the in-flight scatter's pred lane
    with clears and indices wrapped once from below."""
    T, W, I, KA, KI = (SHAPE[k] for k in ("T", "W", "I", "KA", "KI"))
    f32 = np.float32
    pred = rng.choice(np.array([0.0, -1.0, 0.005, 0.02, 0.5, 2.0], f32), I)
    pred[rng.random(I) < 0.01] = np.nan
    thr = np.maximum(SPEC_MULT * np.nan_to_num(pred.astype(np.float64)),
                     SPEC_MIN_S)
    factor = rng.choice(np.array([0.25, 1.0, 1.5, 4.0]), I)
    leaves = dict(leaves, infl_pred=pred,
                  infl_start=(now - thr * factor).astype(f32),
                  avoid=np.where(rng.random(T) < 0.8, -1,
                                 rng.integers(-2, W + 2, T)).astype(np.int32))
    lanes = 1 + int(use_priority) + int(tenancy)
    cut = 9 + KA * lanes
    at_idx = cut + 2 * (SHAPE["KH"] + SHAPE["KF"])
    infl_end = at_idx + 2 * KI
    body_end = len(pkt) - (3 * NT_HEADLINE if tenancy else 0)
    pkt = pkt.copy()
    n_if = int(pkt[4])
    wrap = rng.random(n_if) < 0.3
    pkt[at_idx : at_idx + n_if][wrap] -= I  # wraps once onto the same slot
    arr = np.where(rng.random(KA) < 0.5, -1,
                   rng.integers(-2, W + 2, KA)).astype(f32)
    arr[:3] = [np.nan, 1e10, 7.9]
    pred_lane = rng.choice(np.array([0.0, 0.02, 0.5, -1.0, np.nan], f32), KI)
    pkt = np.concatenate([pkt[:cut], arr, pkt[cut:infl_end], pred_lane,
                          pkt[infl_end:body_end],
                          np.array([SPEC_MULT, SPEC_MIN_S], f32),
                          pkt[body_end:]]).astype(f32)
    return leaves, pkt


def spec_violations(res, avoid_leaf: torch.Tensor) -> int:
    """Tasks one launch placed (reported) on their avoid row."""
    ok = res.placed_slots >= 0
    slots = res.placed_slots[ok].long()
    return int((avoid_leaf[slots] == res.placed_rows[ok]).sum())


def spec_bound_ms(packet: torch.Tensor) -> float:
    """The lane's own bytes at the HBM rate: infl_start and infl_pred read
    over I, the avoid leaf read over T, the KG straggler slots written; the
    arrivals' avoid lane read and their rows written; the pred lane read
    and each scattered slot's stamp and prediction written; the 2-float
    tail. The fixup's reads of speed, free and liveness are the rank
    tick's own."""
    T, I = SHAPE["T"], SHAPE["I"]
    n_arr, n_if = int(packet[1]), int(packet[4])
    return ((8 * I + 4 * T + 4 * KG + 8 * n_arr + 12 * n_if + 8)
            / HBM_BYTES_PER_S * 1e3)


def spec_branch(name: str):
    from tpu_faas_torch.sched.fused_tick import KERNEL

    return {"rank": lambda p, st, k: KERNEL(p, st, flush=False, **k),
            "auction": lambda p, st, k: KERNEL.auction(p, st, **k),
            "sinkhorn": lambda p, st, k: KERNEL.sinkhorn(p, st, **k)}[name]


def lane_cost_cases(dev, lane: str) -> dict:
    """One synthetic headline state per branch with ``lane`` ("tenancy" or
    "spec") off and on, built as the lane phases build theirs: per branch
    ((packet, state, kw) with the lane off, (packet, state, kw) with it
    on). Tenancy: FCFS, ``with_tenancy``'s table; speculation: priorities,
    ``with_spec``'s lanes, every task the branch's main pass places
    avoiding the row it gets (the veto fires on hundreds). The auction's
    state opens from the seed. ``tools/ab_time.py`` times them in two trees
    in one call."""
    from tpu_faas_torch.sched.resident import state_from_numpy

    spec = lane == "spec"
    rng = np.random.default_rng(40 + int(spec))
    base, bpkt = random_case(rng, spec, now=100.0)
    if spec:
        leaves, pkt = with_spec(base, bpkt, rng, True, False, now=100.0)
        kw_on = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True,
                     **SPEC_KW)
    else:
        leaves, pkt = with_tenancy(base, bpkt, rng, False)
        kw_on = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=False,
                     **TENANCY_KW)
    kw_off = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=spec)
    price = (rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
             / 16).astype(np.float32)
    on_pkt = torch.from_numpy(pkt).to(dev)
    off_pkt = torch.from_numpy(bpkt).to(dev)
    cases = {}
    for name in ("rank", "auction", "sinkhorn"):
        lv, lb = dict(leaves), dict(base)
        if name == "auction":
            lv.update(price=price, refresh=np.asarray(True))
            lb.update(price=price, refresh=np.asarray(True))
        if spec:
            res0, _ = spec_branch(name)(on_pkt, state_from_numpy(
                dict(lv, avoid=np.full(SHAPE["T"], -1, np.int32)), dev),
                kw_on)
            ok = res0.placed_slots >= 0
            lv["avoid"] = lv["avoid"].copy()
            lv["avoid"][res0.placed_slots[ok].long().cpu().numpy()] = (
                res0.placed_rows[ok].cpu().numpy())
        cases[name] = ((off_pkt, state_from_numpy(lb, dev), kw_off),
                       (on_pkt, state_from_numpy(lv, dev), kw_on))
    return cases


def lane_split_text(lanes: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in lanes.items()) + " ms"


def lane_probe_splits(dev, probe, lane: str, name: str, off: tuple,
                      on: tuple) -> int:
    """The auction or Sinkhorn branch's lanes' parts by the probe build
    (``lane_split``: block 0's packet and liveness, the tenancy
    eligibility, the fixup, the deficit carry and the compaction) on one
    state with ``lane`` off and on, each (packet, state, kw); the probe's
    launches beside the kernel proper's. Returns the fields where they
    differ."""
    split = {"auction": auction_split, "sinkhorn": sinkhorn_probe}[name]
    bad, parts = 0, []
    for packet, pre, kw in (off, on):
        sp, b = split(dev, probe, packet, pre, kw)
        bad += b
        parts.append(sp["lanes"])
    log(f"  {name} lanes' parts by the probe build, {lane} lane off: "
        f"{lane_split_text(parts[0])}; on: {lane_split_text(parts[1])}")
    return bad


#: the hedge fixup's edge states (phase resident_spec): ``with_spec``'s
#: state with every row live, then edited as the name says
FIXUP_EDGES = ("equal", "signed_zero", "nan_inf", "nan_best",
               "avoid_fastest", "emptied", "neg_free", "dead")
#: the kinds with a NaN or -inf speed: the Sinkhorn solve's temperature and
#: potentials are NaN there (its plain version's too), so those run in the
#: rank and auction branches alone
NONFINITE_EDGES = ("nan_inf", "nan_best")
NAN_ROW, FAST_ROW = 7, 3


def fixup_edge(kind: str, leaves: dict, pkt: np.ndarray,
               rng) -> tuple[dict, np.ndarray]:
    """One of FIXUP_EDGES on a copy of ``leaves``, the packet's heartbeat,
    free, speed and liveness scatters dropped so that the edit holds:
    ``equal`` every speed 1.0 (the keys differ in the row alone);
    ``signed_zero`` every eighth row of speed +0.0 or -0.0 with two raw
    slots past the others' (the fixup's candidates are those rows alone),
    every task valid; ``nan_inf`` 40 NaN and 400 -inf speeds; ``nan_best``
    a NaN row with 1,000 raw slots (no vetoed task avoids it: it is every
    one's best); ``avoid_fastest`` one row of speed 100 with 50 raw slots
    past the others (the tasks placed there avoid it); ``emptied`` one raw
    slot past the main pass's on every row, every task valid (each fixup
    step empties its row); ``neg_free`` half the rows with a raw free count
    of -3; ``dead`` every other row dead, the fastest among them."""
    W = SHAPE["W"]
    lv = {k: (v.copy() if isinstance(v, np.ndarray) else v)
          for k, v in leaves.items()}
    pkt = pkt.copy()
    pkt[[2, 3, 5, 6]] = 0.0  # no heartbeat, free, speed or liveness lane
    now = float(pkt[0])
    speed, free, rows = lv["speed"], lv["free"], np.arange(W)
    lv["active"][:] = True
    lv["last_hb"][:] = now
    if kind == "equal":
        speed[:] = 1.0
    elif kind == "signed_zero":
        zero = rows % 8 == 0
        speed[zero] = np.where(rows[zero] % 16 == 0, -0.0, 0.0)
        free[:] = MAX_SLOTS
        free[zero] = MAX_SLOTS + 2
        lv["valid"][:] = True
    elif kind == "nan_inf":
        speed[rng.choice(W, 40, replace=False)] = np.nan
        speed[rng.choice(W, 400, replace=False)] = -np.inf
    elif kind == "nan_best":
        speed[NAN_ROW] = np.nan
        free[NAN_ROW] = 1000
    elif kind == "avoid_fastest":
        speed[FAST_ROW] = 100.0
        free[FAST_ROW] = MAX_SLOTS + 50
    elif kind == "emptied":
        free[:] = MAX_SLOTS + 1
        lv["valid"][:] = True
    elif kind == "neg_free":
        free[: W // 2] = -3
    elif kind == "dead":
        lv["last_hb"][::2] = now - 100.0
        speed[0] = 99.0
        free[0] = 100
    return lv, pkt


def fixup_edge_checks(dev, card: str) -> dict:
    """The hedge fixup's edge states (FIXUP_EDGES) at the headline shape,
    with priorities, the tenancy lane off and on, in all three branches
    (but NONFINITE_EDGES in Sinkhorn):
    every task the branch's main pass places avoids the row it gets (but
    the NaN row, for ``nan_best``), so the veto fires on hundreds; rank
    and auction launches exactly equal to their plain versions, Sinkhorn
    within its contract with the fixup's counts (``spec_fixup_counts``);
    no task on its avoid row, no tenant past its allowance. Returns the
    mismatches and violations per branch."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _resident_tick_impl, state_from_numpy,
    )

    bad = {"rank": 0, "auction": 0, "sinkhorn": 0}
    for tenancy in (False, True):
        for i, kind in enumerate(FIXUP_EDGES):
            rng = np.random.default_rng(60 + 10 * int(tenancy) + i)
            base, bpkt = random_case(rng, True, now=100.0)
            leaves, pkt = (with_tenancy(base, bpkt, rng, True) if tenancy
                           else (base, bpkt))
            leaves, pkt = with_spec(leaves, pkt, rng, True, tenancy,
                                    now=100.0)
            leaves, pkt = fixup_edge(kind, leaves, pkt, rng)
            kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True,
                      **SPEC_KW, **(TENANCY_KW if tenancy else {}))
            packet = torch.from_numpy(pkt).to(dev)
            price = (rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
                     / 16).astype(np.float32)
            line = []
            for name in ("rank", "auction", "sinkhorn"):
                if name == "sinkhorn" and kind in NONFINITE_EDGES:
                    continue
                lv = dict(leaves)
                if name == "auction":
                    lv.update(price=price, refresh=np.asarray(True))
                res0, _ = spec_branch(name)(packet, state_from_numpy(
                    dict(lv, avoid=np.full(SHAPE["T"], -1, np.int32)), dev),
                    kw)
                ok = res0.placed_slots >= 0
                slots = res0.placed_slots[ok].long().cpu().numpy()
                rows = res0.placed_rows[ok].cpu().numpy()
                if kind == "nan_best":
                    slots = slots[rows != NAN_ROW]
                    rows = rows[rows != NAN_ROW]
                lv["avoid"] = lv["avoid"].copy()
                lv["avoid"][slots] = rows
                pre = state_from_numpy(lv, dev)
                label = f"fixup edge {kind}{' tenancy' if tenancy else ''}"
                if name == "rank":
                    res_p, new_p = _resident_tick_impl(
                        packet, clone_state(pre), **kw)
                    res_k, new_k = KERNEL(packet, clone_state(pre),
                                          flush=False, **kw)
                    torch.cuda.synchronize()
                    b1, _ = compare(res_k, res_p, f"{label} rank out")
                    b2, _ = compare(new_k, new_p, f"{label} rank state")
                    b = b1 + b2 + spec_violations(res_k, new_k.avoid)
                elif name == "auction":
                    b = compare_auction_tick(dev, lv, pkt, True,
                                             f"{label} auction",
                                             plain_twin=False,
                                             tenancy=tenancy, spec=True)[0]
                    res_k, new_k = KERNEL.auction(packet, clone_state(pre),
                                                  **kw)
                else:
                    res_k, new_k = KERNEL.sinkhorn(packet, clone_state(pre),
                                                   **kw)
                    torch.cuda.synchronize()
                    b = sinkhorn_check(pre, packet, res_k, new_k, kw,
                                       f"{label} sinkhorn")["bad"]
                if tenancy:
                    b += tenancy_violations(res_k, new_k.tenant, pkt)
                arrived = res_k.arrival_slots.cpu().numpy()
                placed = res_k.placed_slots.cpu().numpy()
                rehomed = int((np.isin(placed, slots)
                               & ~np.isin(placed, arrived)).sum())
                if rehomed > 64 or (kind == "nan_best" and rehomed):
                    log(f"  MISMATCH {label} {name}: {rehomed} re-placed")
                    b += 1
                bad[name] += b
                line.append(f"{name} {len(slots)} vetoed, {rehomed} "
                            f"re-placed, {b} bad")
            log(f"  {label}: {'; '.join(line)}")
    log(f"  the fixup's edge states, {len(FIXUP_EDGES)} kinds x tenancy "
        f"off and on x 3 branches (Sinkhorn "
        f"{len(FIXUP_EDGES) - len(NONFINITE_EDGES)} kinds): mismatches and "
        f"violations {bad} [{card}]")
    return bad


def phase_resident_spec(dev, card: str, probe) -> dict:
    """B1's speculation lane in its three branches: against the plain version
    on synthetic headline states (tenancy lane off and on); its time with
    the lane on against the same state with it off; then a resident loop
    per branch (``phase_resident`` with ``spec=True``), and the rank loop
    with the tenancy lane too, each launch counted with the counts set to 0
    just before the loop and read just after; and the rank branch with the
    lane on the rank loop's own states, beside its plain version and its
    bound, for the kernels line."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import (
        _flush_kernel_impl, _resident_tick_impl, state_from_numpy,
    )

    bad = {"rank": 0, "auction": 0, "sinkhorn": 0}
    err = dict.fromkeys(bad, 0.0)  # Sinkhorn: max |dg|/tau (contract b)
    lane = {}  # branch -> (ms with the lane off, ms with it on)
    most_vetoed = 0
    for tenancy in (False, True):
        rng = np.random.default_rng(30 + int(tenancy))
        base, bpkt = random_case(rng, True, now=100.0)
        leaves, pkt = (with_tenancy(base, bpkt, rng, True) if tenancy
                       else (base, bpkt))
        leaves, pkt = with_spec(leaves, pkt, rng, True, tenancy, now=100.0)
        kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True, **SPEC_KW,
                  **(TENANCY_KW if tenancy else {}))
        packet = torch.from_numpy(pkt).to(dev)
        tag = f"spec{' tenancy' if tenancy else ''}"
        by_branch = {}
        for name in ("rank", "auction", "sinkhorn"):
            lv = dict(leaves)
            if name == "auction":
                lv.update(price=(rng.integers(0, 64, SHAPE["W"] * MAX_SLOTS)
                                 / 16).astype(np.float32),
                          refresh=np.asarray(True))
            # the veto's target: each task this branch's main pass places
            # (the first KP reported, with no avoid row anywhere) avoids the
            # very row it gets, so the veto fires on all of them and the
            # fixup's bound of 64 binds
            res0, _ = spec_branch(name)(packet, state_from_numpy(
                dict(lv, avoid=np.full(SHAPE["T"], -1, np.int32)), dev), kw)
            ok = res0.placed_slots >= 0
            slots = res0.placed_slots[ok].long().cpu().numpy()
            lv["avoid"] = lv["avoid"].copy()
            lv["avoid"][slots] = res0.placed_rows[ok].cpu().numpy()
            assert len(slots) > 64 + SHAPE["KA"], "the fixup's bound idles"
            most_vetoed = max(most_vetoed, len(slots))
            by_branch[name] = lv
            pre = state_from_numpy(lv, dev)
            if name == "auction":
                b, e, rounds, spilled, rows = compare_auction_tick(
                    dev, lv, pkt, True, f"{tag} auction", plain_twin=False,
                    tenancy=tenancy, spec=True)
                res_k, _ = spec_branch(name)(packet, clone_state(pre), kw)
                log(f"  {tag} auction: rounds {rounds}, spilled {spilled}, "
                    f"bidder rows {rows}, mismatched fields and violations "
                    f"{b}")
            elif name == "sinkhorn":
                res_k, new_k = KERNEL.sinkhorn(packet, clone_state(pre), **kw)
                torch.cuda.synchronize()
                c = sinkhorn_check(pre, packet, res_k, new_k, kw,
                                   f"{tag} sinkhorn")
                b = c["bad"] + (tenancy_violations(res_k, new_k.tenant, pkt)
                                if tenancy else 0)
                e = c["dg"]
                log(f"  {tag} sinkhorn: placed {c['placed']}, |dg|/tau "
                    f"{c['dg']:.3e}, contract violations {c['bad']}, "
                    f"placements {'differ from' if c['differs'] else 'equal'}"
                    f" the plain version's")
            else:
                res_p, new_p = _resident_tick_impl(packet, clone_state(pre),
                                                   **kw)
                res_k, new_k = KERNEL(packet, clone_state(pre), flush=False,
                                      **kw)
                fkw = {k: v for k, v in kw.items()
                       if k not in ("KP", "KR", "max_slots")}
                fst_p, farr_p = _flush_kernel_impl(packet, clone_state(pre),
                                                   **fkw)
                fst_k, farr_k = KERNEL(packet, clone_state(pre), flush=True,
                                       **kw)
                torch.cuda.synchronize()
                b1, e1 = compare(res_k, res_p, f"{tag} rank out")
                b2, e2 = compare(new_k, new_p, f"{tag} rank state")
                b3, e3 = compare(fst_k, fst_p, f"{tag} flush state")
                b = (b1 + b2 + b3 + int(not torch.equal(farr_k, farr_p))
                     + spec_violations(res_k, new_k.avoid)
                     + (tenancy_violations(res_k, new_k.tenant, pkt)
                        if tenancy else 0))
                e = max(e1, e2, e3)
            # the vetoed tasks placed after all (arrivals carry the
            # packet's avoid rows, not these)
            arrived = res_k.arrival_slots.cpu().numpy()
            placed = res_k.placed_slots.cpu().numpy()
            rehomed = int((np.isin(placed, slots)
                           & ~np.isin(placed, arrived)).sum())
            n_flag = int((res_k.straggler_slots >= 0).sum())
            log(f"  {tag} {name}: {len(slots)} tasks avoid the row placement "
                f"gives them, {rehomed} re-placed by the fixup (at most 64), "
                f"{n_flag} of KG={KG} straggler slots reported, mismatched "
                f"fields and violations {b}")
            assert rehomed <= 64 and n_flag == KG
            bad[name] += b
            err[name] = max(err[name], e)
        if tenancy:
            continue
        # the lane's cost: the same state with the lane off and on
        kw_off = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True)
        off_pkt = torch.from_numpy(bpkt).to(dev)
        for name, n in (("rank", N_TIMED), ("auction", 3), ("sinkhorn", 10)):
            s_on = state_from_numpy(by_branch[name], dev)
            s_off = state_from_numpy(dict(
                by_branch[name], infl_start=base["infl_start"],
                infl_pred=base["infl_pred"], avoid=base["avoid"]), dev)
            call = spec_branch(name)
            t_off = event_ms(lambda st: call(off_pkt, st, kw_off), n,
                             setup=lambda s0=s_off: clone_state(s0))
            t_on = event_ms(lambda st: call(packet, st, kw), n,
                            setup=lambda s0=s_on: clone_state(s0))
            lane[name] = (statistics.median(t_off), statistics.median(t_on))
            log(f"  {name} kernel on one synthetic state, speculation lane "
                f"off {lane[name][0]:.4f} ms, on {lane[name][1]:.4f} ms "
                f"(+{lane[name][1] - lane[name][0]:.4f} ms), medians of {n} "
                f"[{card}]")
            if name != "rank":
                bad[name] += lane_probe_splits(
                    dev, probe, "speculation", name, (off_pkt, s_off, kw_off),
                    (packet, s_on, kw))
    # the plain fixup reads nothing back to the host: its 64 steps under
    # the sync check, every task vetoed (its avoid row is its placement)
    from tpu_faas_torch.spec.straggler import hedge_fixup_impl

    lv = by_branch["rank"]
    assign = torch.from_numpy(np.where(lv["valid"], lv["avoid"], -1)).to(dev)
    args = (assign, assign, torch.from_numpy(lv["speed"]).to(dev),
            torch.from_numpy(lv["free"]).to(dev),
            torch.from_numpy(lv["active"]).to(dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fixed = hedge_fixup_impl(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_fixed = int(((assign >= 0) & (fixed >= 0)).sum())
    assert 0 < n_fixed <= 64, f"the plain fixup re-placed {n_fixed}"
    for name, b in fixup_edge_checks(dev, card).items():
        bad[name] += b
    fix_ms = statistics.median(event_ms(lambda _: hedge_fixup_impl(*args),
                                        10))
    log(f"  the plain fixup alone (64 steps of torch ops, no host read): "
        f"{fix_ms:.4f} ms on the card, {n_fixed} tasks re-placed [{card}]")
    if sum(bad.values()):
        raise SystemExit(f"the speculation lane disagrees with its plain "
                         f"version: {bad}")
    log(f"phase speculation kernel: rank and auction ticks and flushes "
        f"exactly equal, Sinkhorn within its contract, no task on its avoid "
        f"row; up to {most_vetoed} tasks vetoed in one state")

    loops = {}
    for name, (n_checked, n_timed) in SPEC_TICKS.items():
        placement = name.split("+")[0]
        KERNEL.launches = KERNEL.auction_launches = 0
        KERNEL.sinkhorn_launches = KERNEL.tenancy_launches = 0
        KERNEL.spec_launches = 0
        r = phase_resident(dev, n_checked, n_timed, placement=placement,
                           tenancy="tenancy" in name, spec=True)
        r["spec_launches"] = KERNEL.spec_launches
        assert r["spec_launches"] > 0, f"{name}: the lane never ran"
        assert r["flagged"] > 0, f"{name}: no straggler flagged"
        bad[placement] += r["mismatches"] + r["on_avoid"]
        err[placement] = max(err[placement], r["max_abs_err"])
        loops[name] = r
        log(f"  integrated tick_resident with speculation, {name} (diff, "
            f"pack, upload, kernel; synchronized): "
            f"{statistics.median(r['tick_ms']):.4f} ms against the 5 ms "
            f"period, host enqueue alone "
            f"{statistics.median(r['tick_enqueue_ms']):.4f} ms, packet "
            f"upload + kernel on the card "
            f"{statistics.median(r['launch_ms']):.4f} ms, medians of "
            f"{len(r['tick_ms'])} ticks; launches with the lane "
            f"{r['spec_launches']} [{card}]")

    # the main path's entry: the rank branch with the lane on the rank
    # loop's own states, its plain version on the same states, its bound
    samples = loops["rank"]["samples"]
    kw = dict(SHAPE, max_slots=MAX_SLOTS, use_priority=True, **SPEC_KW)
    order = iter(range(10**9))

    def next_sample():
        packet, pre, _ = samples[next(order) % len(samples)]
        return packet, clone_state(pre)

    k_ms = event_ms(lambda a: KERNEL(a[0], a[1], flush=False, **kw),
                    len(samples), setup=next_sample)
    p_ms = event_ms(lambda a: _resident_tick_impl(a[0], a[1], **kw),
                    len(samples), setup=next_sample)
    lane_b = statistics.median(spec_bound_ms(p.cpu()) for p, _, _ in samples)
    bound = statistics.median(bound_ms(True, p.cpu()) for p, _, _ in samples)
    log(f"  rank kernel with the lane on the speculation loop's own states: "
        f"{statistics.median(k_ms):.4f} ms (min {min(k_ms):.4f}), plain "
        f"version {statistics.median(p_ms):.4f} ms, bound {bound + lane_b:.6f}"
        f" ms (bytes: the rank tick's {bound:.6f} ms plus the lane's own "
        f"{lane_b:.6f} ms), medians of {len(k_ms)} [{card}]")
    resident_rank_split(dev, probe, samples, kw,
                        "the speculation rank loop's states")
    return {"mismatches": bad, "max_abs_err": err, "lane": lane,
            "loops": loops, "ms": statistics.median(k_ms),
            "plain_ms": statistics.median(p_ms), "bound_ms": bound + lane_b,
            "lane_bound_ms": lane_b,
            "launches": loops["rank"]["spec_launches"]}


# -- phase 11: the graph frontier on the batch tick ---------------------------
#: config 13's diamonds (tpu_faas/bench/configs.py:1662): one root, 8
#: middles, one sink; 5,120 of them fill the headline batch
GRAPH_WIDTH = 8
GRAPH_SPEEDS = np.array([0.5, 1.0, 2.0, 4.0], np.float32)  # equal classes
GRAPH_TIMED = 5


class _Node:
    def __init__(self, task_id: str) -> None:
        self.task_id = task_id


def graph_batch():
    """The headline batch as 5,120 diamonds held in a GraphFrontier: about
    half of the parents confirmed (a few failed), each confirmed-ok parent
    with the worker row that ran it and a result digest held by that row
    and one other. Returns the frontier's padded lanes."""
    from tpu_faas_torch.graph.frontier import GraphFrontier

    T, W = SHAPE["T"], SHAPE["W"]
    n_graphs = T // (GRAPH_WIDTH + 2)
    rng = np.random.default_rng(13)
    g = GraphFrontier(cap=T)
    ids, holder_rows = [], {}
    for d in range(n_graphs):
        root, sink = f"r{d}", f"s{d}"
        mids = [f"m{d}-{j}" for j in range(GRAPH_WIDTH)]
        for m in mids:
            g.add(_Node(m), [root])
        g.add(_Node(sink), mids)
        ids += [root, *mids, sink]
        for p in (root, *mids):
            if rng.random() < 0.5:
                row = int(rng.integers(0, W))
                digest = f"{p}-result"
                g.note_parent(p, rng.random() < 0.95, row=row, digest=digest,
                              size=int(rng.integers(1, 1 << 20)))
                holder_rows[digest] = {row, int(rng.integers(0, W))}
    sizes = rng.lognormal(0.0, 1.0, T).astype(np.float32)
    rows = {r: tid for r, tid in enumerate(ids) if tid in g.waiting}
    child, undone, pref = g.edge_arrays(rows, T)
    lanes = dict(dep_edges=(child, undone), task_pref=pref,
                 pref_edges=g.pref_arrays(rows, T, holder_rows))
    return sizes, lanes, len(rows)


def graph_arrays(dev, placement: str):
    """The headline fleet for the batch tick: 4,096 workers of 1-8 slots
    in four equal-speed classes, 2,000 tasks in flight, and after one
    empty tick 64 rows silent past time_to_expire, so the tick purges and
    redispatches too."""
    from tpu_faas_torch.sched.state import SchedulerArrays

    W = SHAPE["W"]
    rng = np.random.default_rng(14)
    clock = [1000.0]
    sa = SchedulerArrays(max_workers=W, max_pending=SHAPE["T"],
                         max_inflight=SHAPE["I"], max_slots=MAX_SLOTS,
                         clock=lambda: clock[0], placement=placement,
                         device=dev)
    procs = rng.integers(1, MAX_SLOTS + 1, W)
    speeds = rng.choice(GRAPH_SPEEDS, W)
    for i in range(W):
        sa.register(b"w%d" % i, int(procs[i]), speed=float(speeds[i]))
    sa.tick(np.zeros(0, np.float32))  # every row live last tick
    silent = rng.choice(W, 64, replace=False)
    for k, row in enumerate(rng.integers(0, W, 2_000)):
        sa.inflight_add(f"run{k}", int(row))
    sa.last_heartbeat[silent] -= 20.0
    return sa


def graph_violations(a: np.ndarray, base: np.ndarray, lanes: dict,
                     pref: np.ndarray, sa) -> dict:
    """The graph lanes' invariants on one tick's assignment ``a``: no row
    with an unconfirmed parent placed, no worker past min(free, K), and
    against ``base`` (the same tick without preferences) every changed
    task one of a swap between equal-speed workers: the wanter on its
    preferred row, the holder on the row the wanter left."""
    T = SHAPE["T"]
    child, undone = lanes["dep_edges"]
    blocked = np.bincount(child[child < T], weights=undone[child < T],
                          minlength=T) > 0
    cap = np.minimum(sa.worker_free, MAX_SLOTS)
    used = np.bincount(a[a >= 0], minlength=len(cap))
    speed = sa.worker_speed
    moved = np.flatnonzero(a != base)
    wanters = {int(t) for t in moved if base[t] >= 0 and a[t] == pref[t]}
    left = {int(base[t]): int(t) for t in wanters}
    bad_swaps = 0
    for t in moved:
        t = int(t)
        if base[t] < 0 or a[t] < 0 or speed[a[t]] != speed[base[t]]:
            bad_swaps += 1
        elif t not in wanters and left.get(int(a[t])) is None:
            bad_swaps += 1
    return dict(blocked_placed=int((a[blocked] >= 0).sum()),
                over_booked=int((used > cap).sum()),
                bad_swaps=bad_swaps, moved=len(moved),
                wanters=len(wanters), blocked=int(blocked.sum()))


def graph_tick_ms(arr, sizes, kw: dict) -> list[float]:
    """The batch tick's time by CUDA events, each call queued behind a spin
    kernel after a synchronize (so the previous call's pinned staging
    buffers are free again, as in a dispatcher's loop), two warm-ups."""
    times = []
    for i in range(GRAPH_TIMED + 2):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        arr.tick(sizes, **kw)
        b.record()
        if i >= 2:
            times.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in times]


def phase_graph(dev, card: str) -> dict:
    """The graph frontier on the batch tick at the headline shape (see the
    module docstring): rank exactly equal to the port's CPU run of the
    same inputs; auction (B2 launched) and Sinkhorn held to the
    invariants; the tick's card time with the lanes on and off."""
    from tpu_faas_torch.graph.frontier import parent_pref_impl
    from tpu_faas_torch.sched import bid, state

    sizes, lanes, n_waiting = graph_batch()
    T = SHAPE["T"]
    pc, pr, pb = lanes["pref_edges"]
    byte_pref = parent_pref_impl(*(torch.from_numpy(x) for x in (pc, pr, pb)),
                                 T=T).numpy()
    pref = np.where(byte_pref >= 0, byte_pref, lanes["task_pref"])
    child = lanes["dep_edges"][0]
    log(f"  batch: {T // (GRAPH_WIDTH + 2)} diamonds of width {GRAPH_WIDTH}, "
        f"{n_waiting} waiting nodes, {int((child < T).sum())} edges padded "
        f"to {len(child)}, {int((pc < T).sum())} pref lanes padded to "
        f"{len(pc)}, {int((pref >= 0).sum())} rows with a preference")
    # the pre-exchange assignment of each tick: what the exchange was given
    seen = []
    real = state.locality_exchange

    def spy(assignment, task_pref, worker_speed):
        seen.append(assignment.cpu().numpy())
        return real(assignment, task_pref, worker_speed)

    stats = {"mismatches": 0, "ms": {}, "b2_launches": 0}
    fields = ("assignment", "live", "purged", "redispatch")
    for placement in ("rank", "auction", "sinkhorn"):
        sa = graph_arrays(dev, placement)
        bid.KERNEL.launches = 0  # count this path alone
        state.locality_exchange = spy
        try:
            out = sa.tick(sizes, **lanes)
            torch.cuda.synchronize()
        finally:
            state.locality_exchange = real
        b2 = bid.KERNEL.launches
        a = out.assignment.cpu().numpy()
        base = graph_arrays(dev, placement).tick(
            sizes, dep_edges=lanes["dep_edges"]).assignment.cpu().numpy()
        assert np.array_equal(seen.pop(), base), (
            f"{placement}: the tick without preferences placed otherwise "
            f"than the exchange's input")
        v = graph_violations(a, base, lanes, pref, sa)
        placed = int((a >= 0).sum())
        if placement == "rank":
            # the lanes add no host sync to the rank tick
            arr = graph_arrays(dev, placement)
            torch.cuda.set_sync_debug_mode("error")
            try:
                arr.tick(sizes, **lanes)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            cpu = graph_arrays("cpu", placement).tick(sizes, **lanes)
            bad = [f for f in fields if not np.array_equal(
                getattr(out, f).cpu().numpy(), getattr(cpu, f).numpy())]
            stats["mismatches"] += len(bad)
            assert not bad, f"rank graph tick: card != CPU on {bad}"
        else:
            assert placement != "auction" or b2 > 0, "B2 never launched"
        assert not (v["blocked_placed"] or v["over_booked"]
                    or v["bad_swaps"]), f"{placement}: {v}"
        assert v["moved"] > 0 and placed > 0, f"{placement}: {v}"
        if placement == "auction":
            stats["b2_launches"] = b2
        log(f"  {placement}: placed {placed}, purged "
            f"{int(out.purged.sum())}, redispatched "
            f"{int(out.redispatch.sum())}; {v['blocked']} rows blocked, "
            f"{v['blocked_placed']} of them placed; over-booked rows "
            f"{v['over_booked']}; the exchange moved {v['moved']} tasks "
            f"({v['wanters']} onto their preferred row), every move a swap "
            f"between equal-speed workers"
            + (", equal to the CPU run on every output"
               if placement == "rank" else f"; B2 launches {b2}"
               if placement == "auction" else ""))
        # the tick's card time, lanes on and off (CUDA events, medians)
        for on in (False, True):
            arr = graph_arrays(dev, placement)
            stats["ms"][placement, on] = statistics.median(
                graph_tick_ms(arr, sizes, lanes if on else {}))
        log(f"  {placement} batch tick, CUDA events, median of {GRAPH_TIMED}"
            f"{'' if placement == 'rank' else ' (its host syncs included)'}: "
            f"graph lanes off {stats['ms'][placement, False]:.4f} ms, on "
            f"{stats['ms'][placement, True]:.4f} ms [{card}]")
    log("phase graph: rank exactly equal to its CPU run, auction and "
        "Sinkhorn with zero invariant violations")
    return stats


# -- phase 13: the tpu-push dispatcher ----------------------------------------
#: leg 1: wire workers in this process, each REGISTERed with 8 processes
N_WIRE_WORKERS, WIRE_PROCS = 16, 8
N_REQUESTS = 512
#: requests written per store batch, and the pause between batches
REQUEST_CHUNK, REQUEST_GAP_S = 16, 0.03
#: the workers' heartbeat period and the dispatcher's time_to_expire
#: (seconds; its default is 10 s): the silenced worker's purge and the
#: redispatch of its tasks land within the phase
WIRE_HB_S, WIRE_TTE_S = 0.3, 2.0
#: leg 2: tasks, workers and processes each, config_9_host_dispatch's
#: default shape (tpu_faas/bench/configs.py:683)
HOST_SHAPE = (20_000, 4_096, 8)
#: leg 2: announces written per store batch and drained before the next.
#: The recipe writes 2,000 at once and drains after; on the card machine a
#: burst past about 64 KiB to one subscriber stalls the bus (ROADMAP C.5)
HOST_FEED_CHUNK = 1_000


def smoke_fn(x: int) -> int:
    """What the serve leg's requests run: small and deterministic."""
    return 3 * x + 1


class WireWorker:
    """A push worker on the dispatcher's wire, in a thread of this process:
    a DEALER socket that sends REGISTER (``num_processes``), a HEARTBEAT
    every ``WIRE_HB_S`` and a RESULT for each TASK, whose payload it runs
    through the port's executor (the framing of
    tpu_faas/worker/push_worker.py; nothing of it is imported). After
    ``silent`` is set it sends nothing and answers nothing."""

    def __init__(self, url: str, name: str) -> None:
        import threading

        self.url, self.ident = url, name.encode()
        self.silent = threading.Event()
        self.stopping = threading.Event()
        self.ran = 0
        self.thread = threading.Thread(target=self._run, name=name,
                                       daemon=True)
        self.thread.start()

    def _run(self) -> None:
        import zmq

        from tpu_faas_torch.core.executor import execute_fn
        from tpu_faas_torch.worker import messages as m

        sock = zmq.Context.instance().socket(zmq.DEALER)
        sock.setsockopt(zmq.IDENTITY, self.ident)
        sock.setsockopt(zmq.LINGER, 0)
        sock.connect(self.url)
        try:
            sock.send(m.encode(m.REGISTER, num_processes=WIRE_PROCS))
            beat = time.monotonic()
            while not self.stopping.is_set():
                if self.silent.is_set():
                    time.sleep(0.01)
                    continue
                if time.monotonic() - beat >= WIRE_HB_S:
                    sock.send(m.encode(m.HEARTBEAT))
                    beat = time.monotonic()
                # woken by a frame, else in time for the next heartbeat:
                # a short poll would take the interpreter lock from the
                # dispatcher's thread hundreds of times a second
                if not sock.poll(50):
                    continue
                kind, data = m.decode(sock.recv())
                if kind == m.TASK:
                    res = execute_fn(data["task_id"], data["fn_payload"],
                                     data["param_payload"],
                                     data.get("timeout"))
                    sock.send(m.encode(m.RESULT, task_id=res.task_id,
                                       status=res.status, result=res.result,
                                       elapsed=res.elapsed,
                                       started_at=res.started_at))
                    self.ran += 1
                elif kind == m.RECONNECT:
                    sock.send(m.encode(m.RECONNECT,
                                       free_processes=WIRE_PROCS))
        finally:
            sock.close()

    def stop(self) -> None:
        self.stopping.set()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive(), f"{self.ident!r} did not stop"


def dispatcher_serve(dev, card: str, n_requests: int = N_REQUESTS) -> dict:
    """Leg 1: the port's TpuPushDispatcher, resident rank placement on
    ``dev`` at its default shape, serving on its own thread: its store is
    the port's in-process store server, wrapped in the port's
    RaceCheckStore; 16 wire workers; ``n_requests`` requests written and
    announced as the gateway writes them (``create_tasks`` on the channel,
    tpu_faas/gateway/app.py:1995-2015), one worker silenced halfway. A
    request's latency runs from its write to the announce of its terminal
    record on the results channel, which is what wakes the gateway's
    /result. Every request must come back COMPLETED with its value,
    exactly once (no race violation), and B1 must have served the ticks."""
    import threading

    from tpu_faas_torch.core.executor import pack_params
    from tpu_faas_torch.core.serialize import deserialize, serialize
    from tpu_faas_torch.core.task import (
        FIELD_RESULT,
        FIELD_STATUS,
        FIELD_SUBMITTED_AT,
        new_task_id,
    )
    from tpu_faas_torch.dispatch.tpu_push import TpuPushDispatcher
    from tpu_faas_torch.obs import render
    from tpu_faas_torch.obs.expofmt import parse_exposition
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.store.base import RESULTS_CHANNEL
    from tpu_faas_torch.store.launch import make_store, start_store_thread
    from tpu_faas_torch.store.racecheck import RaceCheckStore, RaceMonitor

    monitor = RaceMonitor()
    handle = start_store_thread()
    gateway = RaceCheckStore(make_store(handle.url), monitor, "gateway")
    watcher = make_store(handle.url)
    results = watcher.subscribe(RESULTS_CHANNEL)
    disp = TpuPushDispatcher(
        ip="127.0.0.1", port=0, resident=True, placement="rank", device=dev,
        time_to_expire=WIRE_TTE_S,
        store=RaceCheckStore(make_store(handle.url), monitor, "dispatcher"))
    KERNEL.launches = 0  # count this leg alone
    serve = threading.Thread(target=disp.start, name="dispatcher",
                             daemon=True)
    serve.start()
    url = f"tcp://127.0.0.1:{disp.port}"
    workers = [WireWorker(url, f"smoke-w{i}") for i in range(N_WIRE_WORKERS)]
    try:
        deadline = time.monotonic() + 60
        while len(disp.arrays.worker_ids) < N_WIRE_WORKERS:
            assert time.monotonic() < deadline, "workers did not register"
            time.sleep(0.01)
        fn = serialize(smoke_fn)
        value, sent, done = {}, {}, {}
        t_first = next_at = time.perf_counter()
        deadline = time.monotonic() + 120
        lo = 0
        while len(done) < n_requests:
            assert time.monotonic() < deadline, (
                f"{n_requests - len(done)} requests unanswered")
            if lo < n_requests and time.perf_counter() >= next_at:
                next_at += REQUEST_GAP_S
                if lo == n_requests // 2:
                    workers[0].silent.set()
                batch = [(new_task_id(), i)
                         for i in range(lo, min(lo + REQUEST_CHUNK,
                                                n_requests))]
                now = time.perf_counter()
                stamp = {FIELD_SUBMITTED_AT: repr(time.time())}
                gateway.create_tasks([(t, fn, pack_params(i), stamp)
                                      for t, i in batch], disp.channel)
                for t, i in batch:
                    value[t], sent[t] = i, now
                lo += len(batch)
            wait = (next_at - time.perf_counter() if lo < n_requests
                    else 0.05)
            tid = results.get_message(timeout=min(max(wait, 0.001), 0.05))
            while tid is not None:
                done.setdefault(tid, time.perf_counter())
                tid = results.get_message()
        t_last = max(done.values())
        ids = list(value)
        assert set(done) == set(ids), "a result announce for no request"
        recs = watcher.hgetall_many(ids)
        wrong = [t for t, rec in zip(ids, recs)
                 if rec.get(FIELD_STATUS) != "COMPLETED"
                 or deserialize(rec[FIELD_RESULT]) != smoke_fn(value[t])]
        assert not wrong, f"{len(wrong)} requests wrong, e.g. {wrong[:3]}"
        monitor.assert_clean()
        assert monitor.unfinished() == [], monitor.unfinished()[:5]
        assert disp.n_purged >= 1, "the silenced worker was never purged"
        assert disp.n_dispatched > n_requests, "nothing was redispatched"
        a = disp.arrays
        ticks = int(disp.tracer.summary()["device_tick"]["count"])
        launches = KERNEL.launches
        assert a.device_dispatches_total > 0 and ticks > 0
        if dev.type == "cuda":
            assert launches > 0, "the dispatcher never launched B1"
    finally:
        disp.stop()
        serve.join(timeout=30)
        for w in workers:
            w.stop()
        results.close()
        for s in (gateway, watcher):
            s.close()
        handle.stop()
    assert not serve.is_alive(), "the dispatcher thread did not stop"
    lat = sorted(1e3 * (done[t] - sent[t]) for t in ids)
    # the dispatcher's own split of each request's life (obs/trace.py's
    # stages): the mean, and the histogram bucket that holds the median
    fam = parse_exposition(render([disp.metrics]))[
        "tpu_faas_task_stage_seconds"]
    stage: dict[str, dict] = {}
    for s in fam.samples:
        if s.labels.get("terminal") != "COMPLETED":
            continue
        st = stage.setdefault(s.labels["stage"], {"buckets": []})
        kind = s.name.rsplit("_", 1)[-1]
        if kind == "bucket":
            st["buckets"].append((float(s.labels["le"]), s.value))
        else:
            st[kind] = s.value
    split = {k: (1e3 * v["sum"] / v["count"],
                 1e3 * next(le for le, c in v["buckets"]
                            if c >= v["count"] / 2))
             for k, v in stage.items() if v.get("count")}
    out = dict(requests=n_requests, wall_s=t_last - t_first,
               per_s=n_requests / (t_last - t_first),
               p50_ms=lat[len(lat) // 2],
               p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
               max_ms=lat[-1], ticks=ticks, launches=launches,
               dispatches=a.device_dispatches_total,
               dispatched=disp.n_dispatched, purged=disp.n_purged,
               silenced_ran=workers[0].ran, stages_ms=split)
    log(f"phase dispatcher, serve: {n_requests} of {n_requests} requests "
        f"COMPLETED with their values, none lost or completed twice (race "
        f"monitor clean), through TpuPushDispatcher(resident=True, rank) on "
        f"its own thread and {N_WIRE_WORKERS} wire workers x {WIRE_PROCS}; "
        f"one silenced halfway, purged ({disp.n_purged}), "
        f"{disp.n_dispatched - n_requests} dispatches redone")
    log(f"  throughput {out['per_s']:.1f} requests/s over "
        f"{out['wall_s']:.3f} s; submit-to-result latency median "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms, max "
        f"{out['max_ms']:.3f} ms; {ticks} device ticks, "
        f"{out['dispatches']} B1 launches ({out['dispatches'] / ticks:.3f} "
        f"a tick; the kernel's own count {launches}) [{card}]")
    log("  the dispatcher's split of a request (obs/trace.py stages; mean, "
        "then the histogram bucket holding the median): " + ", ".join(
            f"{k} {mean:.3f} ms (median <= {med:g} ms)"
            for k, (mean, med) in split.items()) + f" [{card}]")
    return out


def dispatcher_host(dev, card: str, shape: tuple = HOST_SHAPE) -> dict:
    """Leg 2: config_9_host_dispatch's recipe (tpu_faas/bench/
    configs.py:632-760) on the resident rank path: ``shape`` = (tasks,
    workers, processes) registered as ROUTER mirrors that never connect
    (sends to them drop); each pass's records written and announced on the
    dispatcher's channel and every announce drained off the bus into its
    backlog before the clock starts, as the recipe's prebuffer does, but
    in batches of HOST_FEED_CHUNK. The timed pass (``tasks_per_s``) runs on
    a recording scheduler: every launch is replayed through the plain
    version afterwards, outputs and state, and no row may hold more tasks
    than its processes. A second pass on fresh tasks runs under the port's
    TickProfiler, each captured tick held to the wrapper's launches."""
    from tpu_faas_torch.dispatch.tpu_push import TpuPushDispatcher
    from tpu_faas_torch.obs import profile as prof
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import ResidentScheduler
    from tpu_faas_torch.store.launch import make_store, start_store_thread
    from tpu_faas_torch.worker import messages as m

    n_tasks, n_workers, n_procs = shape
    os.environ.pop(prof.PROFILE_DIR_ENV, None)
    handle = start_store_thread()
    store, feeder = make_store(handle.url), make_store(handle.url)
    disp = TpuPushDispatcher(
        ip="127.0.0.1", port=0, store=store, max_workers=n_workers,
        max_pending=min(8192, max(n_tasks, 64)),
        max_inflight=2 * n_tasks + 1024, max_slots=n_procs,
        recover_queued=False, time_to_expire=1e9, resident=True,
        placement="rank", device=dev)
    rs = disp.arrays
    assert type(rs) is ResidentScheduler, type(rs)

    def feed(prefix: str) -> float:
        t0 = time.perf_counter()
        buffered: list[str] = []
        for lo in range(0, n_tasks, HOST_FEED_CHUNK):
            ids = [f"{prefix}{i}"
                   for i in range(lo, min(lo + HOST_FEED_CHUNK, n_tasks))]
            feeder.create_tasks([(t, "F", "P") for t in ids], disp.channel)
            got: list[str] = []
            deadline = time.perf_counter() + 30
            while len(got) < len(ids):
                assert time.perf_counter() < deadline, (
                    f"the bus delivered {lo + len(got)} of {n_tasks} "
                    f"announces")
                more = disp.drain_announces(len(ids) - len(got))
                if not more:
                    time.sleep(0.005)
                got.extend(more)
            assert got == ids, "announces out of order or foreign"
            buffered.extend(got)
        disp._announce_backlog.extend(buffered)
        return time.perf_counter() - t0

    def run_pass(prefix: str, per_tick: list | None = None) -> tuple[
            float, int, float]:
        fed = feed(prefix)
        goal = disp.n_dispatched + n_tasks
        ticks = 0
        t0 = time.perf_counter()
        while disp.n_dispatched < goal:
            assert time.perf_counter() - t0 < 300, "the pass stalled"
            n0 = KERNEL.launches
            disp.tick()
            if per_tick is not None and KERNEL.launches > n0:
                per_tick.append(KERNEL.launches - n0)
            ticks += 1
        assert disp.n_dispatched == goal, "a task dispatched twice"
        return time.perf_counter() - t0, ticks, fed

    try:
        for i in range(n_workers):
            disp._handle(f"bench-w{i}".encode(), m.REGISTER,
                         {"num_processes": n_procs})
        disp.tick()  # builds nothing: the kernel was loaded at construction
        # the timed pass on a recording scheduler: each launch's packet and
        # input state, each tick's state after, replayed once it is done
        rs.__class__ = checked_class()
        rs.kept = []
        KERNEL.launches = 0  # count the timed pass alone
        d0 = rs.device_dispatches_total
        elapsed, ticks, fed = run_pass("host-t")
        launches = KERNEL.launches
        dispatches = rs.device_dispatches_total - d0
        kept, rs.kept = rs.kept, None
        rs.__class__ = ResidentScheduler
        bad, err = 0, 0.0
        for launch_log, after in kept:
            b, e = replay_plain(rs, launch_log[0][2], launch_log, after)
            bad, err = bad + b, max(err, e)
        replayed = sum(len(lg) for lg, _ in kept)
        assert replayed == dispatches, (replayed, dispatches)
        assert bad == 0, f"{bad} mismatches against the plain version"
        # no row over-booked: the workers never answer, so every task of
        # the pass is in flight
        rows = rs.inflight_worker[rs.inflight_worker >= 0]
        per_row = np.bincount(rows, minlength=n_workers)
        assert len(rows) == n_tasks and per_row.max() <= n_procs, (
            len(rows), int(per_row.max()))
        assert (rs.worker_free >= 0).all()
        # pass 2 on fresh tasks, every tick captured; the recipe's reset of
        # the free lanes (no results flow back)
        rs.worker_free[:] = n_procs
        os.environ[prof.PROFILE_DIR_ENV] = PROFILE_DIR
        os.environ[prof.PROFILE_TICKS_ENV] = str(10 * ticks + 100)
        disp.profiler = prof.TickProfiler(disp.metrics, log=disp.log)
        KERNEL.launches = 0  # count the captured pass alone
        per_tick: list[int] = []
        _, ticks2, _ = run_pass("host2-t", per_tick)
        disp.profiler.close()
        launches2 = KERNEL.launches
        trace = disp.profiler.trace_path
    finally:
        for var in (prof.PROFILE_DIR_ENV, prof.PROFILE_TICKS_ENV):
            os.environ.pop(var, None)
        disp.stop()
        disp.socket.close(linger=0)
        for s in (store, feeder):
            s.close()
        handle.stop()
    out = dict(tasks_per_s=n_tasks / elapsed, elapsed_s=elapsed,
               fed_s=fed, ticks=ticks, launches=launches,
               dispatches=dispatches, replayed=replayed, mismatches=bad,
               max_abs_err=err, trace=trace, ticks2=ticks2,
               launches2=launches2)
    log(f"phase dispatcher, host dispatch (config 9's recipe, resident "
        f"rank, {n_tasks:,} tasks x {n_workers:,} workers x {n_procs}): "
        f"announces written and drained off the bus in batches of "
        f"{HOST_FEED_CHUNK:,} in {fed:.3f} s before the clock; "
        f"tasks_per_s {out['tasks_per_s']:.1f} ({elapsed:.3f} s, {ticks} "
        f"ticks, {dispatches} B1 launches, the kernel's own count "
        f"{launches}); all {replayed} launches replayed through the plain "
        f"version, {bad} mismatches (max abs err {err:g}); at most "
        f"{int(per_row.max())} tasks a row of {n_procs} processes [{card}]")
    if dev.type == "cuda":
        assert launches == dispatches > 0, (launches, dispatches)
        assert sum(per_tick) == launches2, (per_tick, launches2)
        out["margin_us"] = capture_launches(trace, per_tick)
        out.update(capture_split(trace, "fused_rank_kernel"))
        by_name: dict[str, list[float]] = {}
        for ops in prof.device_ops_by_tick(trace):
            for e in ops:
                if "fused_" in e["name"]:
                    name = e["name"].split("::", 1)[-1].split("(", 1)[0]
                    by_name.setdefault(name, []).append(e["dur"] / 1e3)
        out["b1_by_kernel"] = {k: (len(v), statistics.mean(v))
                               for k, v in by_name.items()}
        log(f"  captured pass ({ticks2} ticks, {trace}; every tick holds the "
            f"B1 launches the wrapper counted, {launches2} in all, the "
            f"closest launch call {out['margin_us']:.3f} us before its "
            f"span's end; "
            + ", ".join(f"{k} {n} x {ms:.4f} ms"
                        for k, (n, ms) in out["b1_by_kernel"].items())
            + f"); the card busy {100 * out['busy']:.2f}% of the "
            f"{out['window_ms']:.3f} ms window; device idle between one "
            f"tick's last operation and the next tick's first "
            f"{out['gap_ms']:.4f} ms (mean); inside a tick's span "
            f"({out['span_ms']:.4f} ms): host work before its first device "
            f"operation {out['lead_ms']:.4f} ms, the device waiting before "
            f"fused_rank_kernel {out['wait_ms']:.4f} ms, host work after it "
            f"{out['tail_ms']:.4f} ms; between spans {out['host_gap_ms']:.4f}"
            f" ms [{card}]")
    return out


def phase_dispatcher(dev, card: str) -> dict:
    """Both legs; the dispatcher imports only the port. Its per-worker
    registration lines are held back (4,096 in leg 2)."""
    import logging

    from tpu_faas_torch.utils.logging import get_logger

    t0 = time.perf_counter()
    get_logger("dispatch").parent.setLevel(logging.WARNING)
    serve = dispatcher_serve(dev, card)
    host = dispatcher_host(dev, card)
    log(f"phase dispatcher: {time.perf_counter() - t0:.1f} s")
    return dict(serve=serve, host=host)


# -- phase 16: the system as separate processes through the port's entry
# points --------------------------------------------------------------------
#: the tpu-push --resident leg's calls: one map, so one burst of at most
#: 1,000 announces (ROADMAP C.5)
STACK_CALLS = 1_000
#: each of the local, pull and push --hb legs' calls
STACK_OTHER_CALLS = 256
#: each push or pull worker's processes
STACK_PROCS = 4
#: the push workers' heartbeat period and the dispatchers' time_to_expire
#: (seconds): a killed worker is purged and its tasks redispatched within
#: the leg
STACK_HB_S, STACK_TTE_S = 0.3, 2.0
#: no leg may take longer (seconds)
STACK_TIMEOUT_S = 180.0
#: the legs: mode, dispatcher flags, worker module, workers, calls, and
#: whether one worker is SIGKILLed halfway
STACK_LEGS = (
    ("tpu-push", ("--resident",), "push_worker", 4, STACK_CALLS, True),
    ("local", ("-w", "4"), None, 0, STACK_OTHER_CALLS, False),
    ("pull", (), "pull_worker", 2, STACK_OTHER_CALLS, False),
    ("push", ("--hb",), "push_worker", 4, STACK_OTHER_CALLS, True),
)


class StackProcesses:
    """The stack's children: each ``python -m <module>`` in a session of
    its own (one killpg reaps a worker's pool children too), its output in
    ``<logdir>/<name>.log``. ``killed`` holds the ones killed on purpose;
    any other child that exits fails :meth:`check`."""

    def __init__(self, root: str, logdir: str) -> None:
        self.root, self.logdir = root, logdir
        self.procs: dict[str, subprocess.Popen] = {}
        self.killed: set[str] = set()
        os.makedirs(logdir, exist_ok=True)
        # host processes need no intra-op threads; the dispatcher's tick
        # runs on the card
        self.env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")

    def start(self, name: str, module: str, *args: str) -> subprocess.Popen:
        with open(os.path.join(self.logdir, f"{name}.log"), "w") as out:
            p = subprocess.Popen(
                [sys.executable, "-m", module, *args], cwd=self.root,
                env=self.env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
        self.procs[name] = p
        return p

    def tail(self, name: str, n: int = 2000) -> str:
        with open(os.path.join(self.logdir, f"{name}.log")) as fh:
            return fh.read()[-n:]

    def check(self) -> None:
        for name, p in self.procs.items():
            if name not in self.killed and p.poll() is not None:
                raise AssertionError(f"{name} exited with {p.returncode}:\n"
                                     + self.tail(name))

    def kill(self, name: str) -> None:
        """SIGKILL on purpose: the worker and its pool children."""
        import signal

        self.killed.add(name)
        os.killpg(self.procs[name].pid, signal.SIGKILL)
        self.procs[name].wait()

    def stop(self, names=None, grace: float = 10.0) -> None:
        """SIGTERM, then SIGKILL after ``grace``; every group reaped."""
        import signal

        names = list(self.procs) if names is None else list(names)
        for name in names:
            p = self.procs[name]
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace
        for name in names:
            p = self.procs.pop(name)
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            try:  # the pool children and helpers too
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            p.wait()


def wait_until(what: str, ready, procs: StackProcesses,
               timeout: float = STACK_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while True:
        procs.check()
        try:
            got = ready()
            if got:
                return got
        except OSError:
            pass
        assert time.monotonic() < deadline, f"{what}: not ready"
        time.sleep(0.1)


def http_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=5) as f:
        return json.loads(f.read())


def http_metric(url: str, name: str) -> float:
    """One sample of a Prometheus text exposition."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=5) as f:
        for line in f.read().decode().splitlines():
            if line.startswith(name + " ") or line.startswith(name + "{"):
                return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not in {url}")


def metric_samples(url: str) -> dict[str, float]:
    """Every sample of a Prometheus text exposition, by its name with its
    labels as written."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=5) as f:
        out = {}
        for line in f.read().decode().splitlines():
            if line and not line.startswith("#"):
                key, val = line.rsplit(" ", 1)
                out[key] = float(val)
        return out


def launches_at_rest(stats: str, tries: int = 50) -> tuple:
    """A tpu-push --resident dispatcher's (B1 launches, resident ticks)
    from one read of its ``/metrics``, taken between two ticks: it counts
    a tick when the tick starts and the tick's launches when it ends, so a
    read while one runs sees one tick more than it launched. Reads until
    the launches reach the ticks (20 ms apart); returns that read, or the
    last one."""
    for _ in range(tries):
        m = metric_samples(stats + "/metrics")
        got = (int(m["tpu_faas_tick_device_dispatches_total"]),
               int(m["tpu_faas_device_ticks_total"]))
        if got[0] >= got[1]:
            return got
        time.sleep(0.02)
    return got


def registered(stats: str) -> int:
    """The workers a dispatcher holds registered: its ``/stats`` where it
    reports them, else the gauge on its ``/metrics``."""
    st = http_json(stats + "/stats")
    if "workers_registered" in st:
        return int(st["workers_registered"])
    return int(http_metric(stats + "/metrics",
                           "tpu_faas_dispatcher_workers_registered"))


def stack_leg(procs: StackProcesses, store_url: str, store, client,
              leg: tuple, device: str, zmq_port: int,
              stats_port: int) -> dict:
    """One leg: the dispatcher of ``mode`` and its workers started through
    their entry points, the calls made with the port's ``FaaSClient.map``,
    one worker SIGKILLed once half the results are announced when the leg
    says so. Every call must come back COMPLETED with its value, each task
    announced on the results channel exactly once; no child but the killed
    one may exit. Returns the leg's numbers; stops the leg's children."""
    import threading

    from tpu_faas_torch.core.serialize import deserialize
    from tpu_faas_torch.core.task import (
        FIELD_FINISHED_AT,
        FIELD_RESULT,
        FIELD_STATUS,
        FIELD_SUBMITTED_AT,
    )
    from tpu_faas_torch.store.base import (
        RESULTS_CHANNEL,
        decode_result_announce,
    )

    mode, flags, worker, n_workers, n_calls, kill = leg
    url = f"tcp://127.0.0.1:{zmq_port}"
    args = ["-m", mode, *flags, "-i", "127.0.0.1", "-p", str(zmq_port),
            "--store", store_url, "--stats-port", str(stats_port),
            "--tte", str(STACK_TTE_S)]
    if mode == "tpu-push":
        args += ["--device", device]
    names = [f"{mode}-dispatcher"]
    t_start = time.perf_counter()
    procs.start(names[0], "tpu_faas_torch.dispatch", *args)
    for i in range(n_workers):
        names.append(f"{mode}-{worker}-{i}")
        # every push worker heartbeats: tpu-push and push --hb purge on
        # silence
        extra = (["--hb", "--hb-period", str(STACK_HB_S)]
                 if worker == "push_worker" else [])
        procs.start(names[-1], f"tpu_faas_torch.worker.{worker}",
                    str(STACK_PROCS), url, *extra)
    stats = f"http://127.0.0.1:{stats_port}"
    sub = store.subscribe(RESULTS_CHANNEL)
    announced: dict[str, int] = {}
    stop = threading.Event()

    def listen() -> None:
        while not stop.is_set():
            msg = sub.get_message(timeout=0.05)
            if msg is not None:
                tid = decode_result_announce(msg)[0]
                announced[tid] = announced.get(tid, 0) + 1

    listener = threading.Thread(target=listen, daemon=True)
    listener.start()
    try:
        # its stats answer once it is built, and so subscribed: an announce
        # made before that is lost by design
        wait_until(f"{mode}: the dispatcher's stats",
                   lambda: http_json(stats + "/stats"), procs)
        if n_workers:
            wait_until(f"{mode}: {n_workers} workers registered",
                       lambda: registered(stats) >= n_workers, procs)
        # one call through the whole path before the clock starts (a pull
        # worker registers nowhere)
        fn = (lambda x: (x * 7919 + 13) % 1_000_003)  # noqa: E731
        assert client.run(fn, -1, timeout=STACK_TIMEOUT_S) == fn(-1)
        t_ready = time.perf_counter()
        handles: list = []
        real_submit = client.submit

        def submit(fid, *a, **kw):
            h = real_submit(fid, *a, **kw)
            handles.append(h)
            return h

        client.submit = submit  # map submits through this: keep the ids
        box: dict = {}

        def run_map() -> None:
            try:
                box["values"] = client.map(fn, range(n_calls),
                                           timeout=STACK_TIMEOUT_S)
            except BaseException as exc:  # re-raised below
                box["error"] = exc

        runner = threading.Thread(target=run_map, daemon=True)
        t0 = time.perf_counter()
        runner.start()
        victim = None
        deadline = time.monotonic() + STACK_TIMEOUT_S + 30
        while runner.is_alive():
            procs.check()
            ids = {h.task_id for h in handles}
            if kill and victim is None and sum(
                    1 for t in announced if t in ids) >= n_calls // 2:
                victim = names[1]
                procs.kill(victim)
            assert time.monotonic() < deadline, f"{mode}: map never returned"
            runner.join(0.02)
        t1 = time.perf_counter()
        client.submit = real_submit
        if "error" in box:
            raise box["error"]
        assert not kill or victim is not None, f"{mode}: nobody was killed"
        values = box["values"]
        assert values == [fn(i) for i in range(n_calls)], f"{mode}: values"
        ids = [h.task_id for h in handles]
        assert len(set(ids)) == n_calls, f"{mode}: {len(set(ids))} task ids"
        time.sleep(0.5)  # a duplicate announce would land by now
        procs.check()
        recs = store.hgetall_many(ids)
        for i, (tid, r) in enumerate(zip(ids, recs)):
            assert r.get(FIELD_STATUS) == "COMPLETED", (mode, tid, r)
            assert deserialize(r[FIELD_RESULT]) == fn(i), (mode, tid)
        twice = {t: n for t, n in announced.items() if n != 1}
        assert not twice and set(ids) <= set(announced), (
            f"{mode}: announces {twice or set(ids) - set(announced)}")
        lat = sorted(1e3 * (float(r[FIELD_FINISHED_AT])
                            - float(r[FIELD_SUBMITTED_AT])) for r in recs)
        out = dict(mode=mode, calls=n_calls, workers=n_workers,
                   killed=victim, served_per_s=n_calls / (t1 - t0),
                   p50_ms=lat[len(lat) // 2],
                   p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))],
                   max_ms=lat[-1],
                   start_s=t_ready - t_start)
        if mode == "tpu-push":
            st = http_json(stats + "/stats")
            out.update(
                tick_backend=st["tick_backend"],
                launches_last_tick=st["device_dispatches_last_tick"])
            out["launches"], out["ticks"] = launches_at_rest(stats)
            want = "fused_cuda" if device == "cuda" else None
            assert out["tick_backend"] == want, out
            assert out["launches"] >= out["ticks"] > 0, out
        if kill:  # the dispatcher purges the killed worker
            wait_until(f"{mode}: the killed worker purged",
                       lambda: registered(stats) == n_workers - 1, procs,
                       timeout=STACK_TTE_S + 10)
        return out
    finally:
        stop.set()
        listener.join(timeout=5)
        sub.close()
        procs.stop(names)


def stack_run(device: str, logdir: str, legs=STACK_LEGS,
              card: str = "") -> list[dict]:
    """Start the store server and the gateway, then each leg of ``legs`` in
    turn through the same two, all through the port's entry points, driven
    by the port's ``FaaSClient`` over REST; every child is reaped."""
    from tpu_faas_torch.client import FaaSClient
    from tpu_faas_torch.store.launch import make_store

    root = os.path.dirname(os.path.abspath(__file__))
    procs = StackProcesses(root, logdir)
    store = None
    out = []
    try:
        store_port, gw_port = free_port(), free_port()
        procs.start("store", "tpu_faas_torch.store.server", "--port",
                    str(store_port))
        store_url = f"resp://127.0.0.1:{store_port}"
        import socket

        def store_up() -> bool:
            with socket.create_connection(("127.0.0.1", store_port), 1):
                return True

        wait_until("store server", store_up, procs)
        procs.start("gateway", "tpu_faas_torch.gateway", "--host",
                    "127.0.0.1", "--port", str(gw_port), "--store",
                    store_url)
        base = f"http://127.0.0.1:{gw_port}"
        wait_until("gateway", lambda: http_json(base + "/healthz"), procs)
        store = make_store(store_url)
        client = FaaSClient(base)
        for leg in legs:
            r = stack_leg(procs, store_url, store, client, leg, device,
                          free_port(), free_port())
            out.append(r)
            b1 = (f", B1 launched {r['launches']:.0f} times in "
                  f"{r['ticks']:.0f} resident ticks (tick_backend "
                  f"{r['tick_backend']}, {r['launches_last_tick']} on the "
                  f"last)" if r["mode"] == "tpu-push" else "")
            log(f"phase stack, -m {r['mode']}: {r['calls']} calls through "
                f"the gateway, {r['workers']} workers"
                + (f" ({r['killed']} SIGKILLed halfway)" if r["killed"]
                   else "")
                + f": every call COMPLETED once with its value; "
                f"{r['served_per_s']:.1f} served/s, submit-to-result median "
                f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms, max "
                f"{r['max_ms']:.2f} ms (store stamps); started in {r['start_s']:.1f} s{b1} [{card}]")
        procs.check()
    finally:
        if store is not None:
            store.close()
        procs.stop()
    return out


def phase_stack(card: str) -> dict:
    """The whole stack as separate processes on the card machine: the
    port's store server, gateway, dispatcher (tpu-push --resident on cuda,
    then local, pull and push --hb) and worker processes, driven over REST
    by the port's client. Logs under chiprun_out/stack/."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    legs = stack_run("cuda", os.path.join(root, "chiprun_out", "stack"),
                     card=card)
    log(f"phase stack: {time.perf_counter() - t0:.1f} s")
    return dict(legs=legs, launches=int(legs[0]["launches"]),
                ticks=int(legs[0]["ticks"]))


# -- phase 16b: the tpu-push dispatcher's opt-in planes through the port's
# entry points ---------------------------------------------------------------
#: leg (a): the calls, the dispatcher's flags and the fleet (workers x
#: processes)
PLANES_EXPRESS_CALLS = 1_000
PLANES_EXPRESS_FLAGS = ("--express", "--batch-max", "16",
                        "--batch-window-ms", "2")
PLANES_EXPRESS_FLEET = (4, 4)
#: leg (a)'s calls go in batches of this many: below the 512 arrivals one
#: delta packet holds (ResidentScheduler.KA), so no burst takes an overflow
#: flush launch and B1 launches once a resident tick
PLANES_EXPRESS_BATCH = 100
#: legs (b) and (c) share one dispatcher and fleet
PLANES_FLEET = (2, 2)
#: leg (b): the priority-0 backlog, the priority-9 calls, each call's sleep
#: (seconds), and the grace after a priority-9 submit within which a
#: priority-0 call placed before its announce reached the dispatcher may
#: still start (a priority-0 call starting later was queued when the
#: priority-9 call arrived). Half the backlog must still be queued when
#: the priority-9 calls arrive: at 100 ms a sleep 4 slots drain 40 calls a
#: second, so the backlog's and the priority-9 calls' submits may take 2.5
#: s between them (at 50 ms, 1.25 s: one card run stamped the priority-9
#: calls late enough that only 87 were left; the calls submitted during
#: the backlog's own submit start at once, so a longer backlog drains as
#: many more)
PLANES_BACKLOG, PLANES_HIGH, PLANES_NAP_S, PLANES_GRACE_S = 200, 20, 0.1, 0.05
#: leg (c): the blockers' sleep, the calls cancelled while queued, the
#: running ones force-cancelled, the calls given a timeout hint shorter than
#: their sleep, and that hint
PLANES_BLOCK_S, PLANES_QUEUED, PLANES_TIMEOUTS, PLANES_HINT_S = 3.0, 10, 5, 0.3
#: leg (d): the calls across two shared dispatchers, each call's sleep, and
#: the lease after which the survivor adopts the dead one's running tasks
PLANES_SHARED_CALLS, PLANES_SHARED_NAP_S, PLANES_LEASE_S = 400, 0.01, 3.0
#: leg (d): the survivor's stranded-task rescan period (seconds)
PLANES_RESCAN_S = 0.5


def b1_counts(stats: str) -> dict:
    """A tpu-push --resident dispatcher's B1 launches and resident ticks
    (:func:`launches_at_rest`), tick backend, calls dispatched and
    TASK/TASK_BATCH frames."""
    launches, ticks = launches_at_rest(stats)
    m = metric_samples(stats + "/metrics")
    st = http_json(stats + "/stats")
    single = next((v for k, v in m.items()
                   if k.startswith("tpu_faas_dispatch_batch_size_bucket")
                   and 'le="1.0"' in k), 0.0)
    frames = m.get("tpu_faas_dispatch_batch_size_count", 0.0)
    return dict(launches=launches, ticks=ticks,
                tick_backend=st["tick_backend"],
                dispatched=int(st["n_dispatched"]),
                task_frames=int(frames), batch_frames=int(frames - single))

class Announces:
    """Every announce on the store's results channel, counted by task id,
    from a thread of its own."""

    def __init__(self, store) -> None:
        import threading

        from tpu_faas_torch.store.base import (
            RESULTS_CHANNEL,
            decode_result_announce,
        )

        self.sub = store.subscribe(RESULTS_CHANNEL)
        self.seen: dict[str, int] = {}
        self._stop = threading.Event()

        def listen() -> None:
            while not self._stop.is_set():
                msg = self.sub.get_message(timeout=0.05)
                if msg is not None:
                    tid = decode_result_announce(msg)[0]
                    self.seen[tid] = self.seen.get(tid, 0) + 1

        self._thread = threading.Thread(target=listen, daemon=True)
        self._thread.start()

    def once(self, ids, what: str) -> None:
        """Each of ``ids`` announced exactly once (a late duplicate would
        land within the half second waited here)."""
        time.sleep(0.5)
        bad = {t: self.seen.get(t, 0) for t in ids if self.seen.get(t) != 1}
        assert not bad, f"{what}: announces {dict(list(bad.items())[:8])}"

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self.sub.close()


def planes_fleet(procs: StackProcesses, store_url: str, tag: str,
                 flags: tuple, fleet: tuple, device: str) -> tuple:
    """One ``tpu-push --resident`` dispatcher with ``flags`` and its push
    workers, started through their entry points; returns the children's
    names and the dispatcher's stats URL once every worker registered."""
    zmq_port, stats_port = free_port(), free_port()
    n_workers, n_procs = fleet
    names = [f"{tag}-dispatcher"]
    procs.start(names[0], "tpu_faas_torch.dispatch", "-m", "tpu-push",
                "--resident", "--device", device, *flags, "-i", "127.0.0.1",
                "-p", str(zmq_port), "--store", store_url, "--stats-port",
                str(stats_port), "--tte", str(STACK_TTE_S))
    for i in range(n_workers):
        names.append(f"{tag}-push_worker-{i}")
        procs.start(names[-1], "tpu_faas_torch.worker.push_worker",
                    str(n_procs), f"tcp://127.0.0.1:{zmq_port}", "--hb",
                    "--hb-period", str(STACK_HB_S))
    return names, f"http://127.0.0.1:{stats_port}"


def fleet_ready(procs: StackProcesses, tag: str, stats: str,
                n_workers: int) -> None:
    wait_until(f"planes {tag}: the dispatcher's stats",
               lambda: http_json(stats + "/stats"), procs)
    wait_until(f"planes {tag}: {n_workers} workers registered",
               lambda: registered(stats) >= n_workers, procs)


def served(store, ids: list, want: list, what: str,
           status: str = "COMPLETED") -> list[float]:
    """Every record of ``ids`` terminal with ``status`` and, for a
    completed one, its value in ``want`` (None skips a value); returns the
    submit-to-result milliseconds from the store's stamps."""
    from tpu_faas_torch.core.serialize import deserialize
    from tpu_faas_torch.core.task import (
        FIELD_FINISHED_AT,
        FIELD_RESULT,
        FIELD_STATUS,
        FIELD_SUBMITTED_AT,
    )

    recs = store.hgetall_many(ids)
    lat = []
    for tid, r, w in zip(ids, recs, want):
        assert r.get(FIELD_STATUS) == status, (what, tid, r.get(FIELD_STATUS))
        if status == "COMPLETED" and w is not None:
            assert deserialize(r[FIELD_RESULT]) == w, (what, tid)
        lat.append(1e3 * (float(r[FIELD_FINISHED_AT])
                          - float(r[FIELD_SUBMITTED_AT])))
    return lat


def leg_numbers(lat: list[float], seconds: float) -> dict:
    lat = sorted(lat)
    return dict(calls=len(lat), served_per_s=len(lat) / seconds,
                p50_ms=lat[len(lat) // 2],
                p99_ms=lat[min(len(lat) - 1, int(0.99 * len(lat)))])


def planes_express(procs, store_url, store, client, device) -> dict:
    """Leg (a): ``--express --batch-max 16 --batch-window-ms 2``, 1,000
    calls of 3x + 1 in batches of 100, each collected with ``wait_many``
    before the next is submitted. Every call answered once
    with its value, inline deliveries at the gateway and TASK_BATCH frames
    above 0, B1 once a resident tick, express sub-ticks included."""
    from tpu_faas_torch.core.serialize import deserialize

    names, stats = planes_fleet(procs, store_url, "express",
                                PLANES_EXPRESS_FLAGS, PLANES_EXPRESS_FLEET,
                                device)
    ann = Announces(store)
    try:
        fleet_ready(procs, "express", stats, PLANES_EXPRESS_FLEET[0])
        fn = (lambda x: 3 * x + 1)  # noqa: E731
        # one call through the whole path before the clock starts
        assert client.run(fn, -1, timeout=STACK_TIMEOUT_S) == fn(-1)
        fid = client.register(fn)
        gw0 = metric_samples(client.base_url + "/metrics")
        n = PLANES_EXPRESS_CALLS
        ids: list[str] = []
        got: dict[str, object] = {}
        deadline = time.monotonic() + STACK_TIMEOUT_S
        t0 = time.perf_counter()
        for lo in range(0, n, PLANES_EXPRESS_BATCH):
            batch = [h.task_id for h in client.submit_many(fid, [
                ((i,), {}) for i in range(
                    lo, min(n, lo + PLANES_EXPRESS_BATCH))])]
            ids += batch
            # the first wait parks before the batch's calls finish, so the
            # announces carrying their results inline wake it
            pending = batch
            while pending:
                procs.check()
                assert time.monotonic() < deadline, "express: results missing"
                results, pending, unknown = client.wait_many(pending,
                                                             wait=5.0)
                assert not unknown, unknown[:4]
                for tid, (status, body) in results.items():
                    assert tid not in got, f"express: {tid} delivered twice"
                    assert status == "COMPLETED", (tid, status)
                    got[tid] = deserialize(body)
        t1 = time.perf_counter()
        assert [got[t] for t in ids] == [3 * i + 1 for i in range(n)]
        lat = served(store, ids, [3 * i + 1 for i in range(n)], "express")
        ann.once(ids, "express")
        procs.check()
        gw1 = metric_samples(client.base_url + "/metrics")
        key = 'tpu_faas_gateway_result_served_total{source="inline"}'
        inline = int(gw1.get(key, 0) - gw0.get(key, 0))
        out = dict(leg="a", **leg_numbers(lat, t1 - t0), inline=inline,
                   **b1_counts(stats))
        want = "fused_cuda" if device == "cuda" else None
        assert out["tick_backend"] == want, out
        assert out["launches"] == out["ticks"] > 0, out
        assert out["inline"] > 0 and out["batch_frames"] > 0, out
        return out
    finally:
        ann.close()
        procs.stop(names)


def planes_priority(procs, store, client, stats, ann) -> dict:
    """Leg (b): a backlog of 200 priority-0 sleeps of 100 ms, then 20
    priority-9 ones. Each call returns the time it started; each
    priority-9 call must start before every priority-0 call still queued
    when it arrived (started later than its submit plus the grace), unless
    the two were placed by one tick (one RUNNING stamp)."""
    from tpu_faas_torch.core.task import FIELD_LEASE_AT, FIELD_SUBMITTED_AT

    # the start time, then the sleep: the list is built in order
    stamped = (lambda s: [__import__("time").time(),  # noqa: E731
                          __import__("time").sleep(s)][0])
    fid = client.register(stamped, name="stamped_sleep")
    c0 = b1_counts(stats)
    t0 = time.perf_counter()
    low = client.submit_many(fid, [((PLANES_NAP_S,), {})] * PLANES_BACKLOG)
    time.sleep(10 * PLANES_NAP_S)  # the backlog flows
    s_call = time.time()
    high = client.submit_many(fid, [((PLANES_NAP_S,), {})] * PLANES_HIGH,
                              priorities=[9] * PLANES_HIGH)
    s_back = time.time()
    start = {h.task_id: h.result(timeout=STACK_TIMEOUT_S)
             for h in low + high}
    t1 = time.perf_counter()
    ids = [h.task_id for h in low + high]
    lat = served(store, ids, [None] * len(ids), "priority")
    ann.once(ids, "priority")
    lease = dict(zip(ids, store.hget_many(ids, FIELD_LEASE_AT)))
    # submitted: the gateway's stamp on the record
    sub = dict(zip(ids, map(float, store.hget_many(ids, FIELD_SUBMITTED_AT))))
    queued = {h.task_id: [q.task_id for q in low if start[q.task_id]
                          > sub[h.task_id] + PLANES_GRACE_S] for h in high}
    n_queued = min(len(v) for v in queued.values())
    assert n_queued >= PLANES_BACKLOG // 2, (
        f"priority: only {n_queued} priority-0 calls still queued")
    late = [(h, q) for h, qs in queued.items() for q in qs
            if start[q] < start[h] and lease[q] != lease[h]]
    assert not late, (
        f"priority: {len(late)} priority-0 calls first; the priority-9 "
        f"submit took {s_back - s_call:.3f} s, stamped "
        f"{min(sub[h] for h in queued) - s_call:.3f}-"
        f"{max(sub[h] for h in queued) - s_call:.3f} s after the call, "
        f"started {min(start[h] for h in queued) - s_call:.3f}-"
        f"{max(start[h] for h in queued) - s_call:.3f} s after it")
    c1 = b1_counts(stats)
    out = dict(leg="b", **leg_numbers(lat, t1 - t0), queued=n_queued,
               pairs=sum(map(len, queued.values())),
               launches=c1["launches"] - c0["launches"],
               ticks=c1["ticks"] - c0["ticks"], tick_backend=c1["tick_backend"],
               inline=0, batch_frames=c1["batch_frames"] - c0["batch_frames"])
    assert out["launches"] == out["ticks"] > 0, out
    return out


def planes_terminals(procs, store, client, stats, ann) -> dict:
    """Leg (c): 4 blockers fill the fleet; 10 calls queued behind them
    cancelled, 2 blockers force-cancelled mid-run, 5 calls with a timeout
    hint shorter than their sleep, then one call that kills its pool
    child, then 8 calls on the same fleet. Terminal states as the JAX
    tests assert: CANCELLED, CANCELLED, FAILED with TaskTimeout, FAILED;
    the other calls COMPLETED with their values."""
    from tpu_faas_torch.client import TaskCancelledError, TaskFailedError
    from tpu_faas_torch.core.executor import TaskTimeout
    from tpu_faas_torch.workloads import sleep_task

    fid = client.register(sleep_task)
    slots = PLANES_FLEET[0] * PLANES_FLEET[1]
    t0 = time.perf_counter()
    blockers = [client.submit(fid, PLANES_BLOCK_S) for _ in range(slots)]
    wait_until("terminals: the blockers running",
               lambda: all(h.status() == "RUNNING" for h in blockers),
               procs)
    queued = [client.submit(fid, 0.01) for _ in range(PLANES_QUEUED)]
    assert all(h.cancel() for h in queued), "terminals: a queued cancel"
    for h in blockers[:2]:
        assert h.cancel(force=True) is False  # async: converges below
    for h in queued + blockers[:2]:
        try:
            h.result(timeout=STACK_TIMEOUT_S)
            raise AssertionError(f"terminals: {h.task_id} ran")
        except TaskCancelledError:
            pass
        assert h.status() == "CANCELLED", h.task_id
    assert [h.result(timeout=STACK_TIMEOUT_S) for h in blockers[2:]] == [
        PLANES_BLOCK_S] * (slots - 2)
    timed = [client.submit_with(fid, args=(30.0,), timeout=PLANES_HINT_S)
             for _ in range(PLANES_TIMEOUTS)]
    for h in timed:
        try:
            h.result(timeout=STACK_TIMEOUT_S)
            raise AssertionError(f"terminals: {h.task_id} outran its hint")
        except TaskFailedError as exc:
            assert isinstance(exc.cause, TaskTimeout), exc.cause
    kill = (lambda: __import__("os").kill(  # noqa: E731
        __import__("os").getpid(), 9))
    poison = client.submit(client.register(kill, name="poison"))
    try:
        poison.result(timeout=STACK_TIMEOUT_S)
        raise AssertionError("terminals: the poison call completed")
    except TaskFailedError:
        pass
    after = [client.submit(fid, 0.01) for _ in range(8)]
    assert [h.result(timeout=STACK_TIMEOUT_S) for h in after] == [0.01] * 8
    t1 = time.perf_counter()
    procs.check()
    states, lat, ids = {}, [], []
    for group, status in ((queued + blockers[:2], "CANCELLED"),
                          (blockers[2:] + after, "COMPLETED"),
                          (timed + [poison], "FAILED")):
        group_ids = [h.task_id for h in group]
        lat += served(store, group_ids, [None] * len(group_ids),
                      "terminals", status)
        states[status] = len(group_ids)
        ids += group_ids
    ann.once(ids, "terminals")
    c = b1_counts(stats)
    return dict(leg="c", **leg_numbers(lat, t1 - t0), states=states,
                launches=c["launches"], ticks=c["ticks"],
                tick_backend=c["tick_backend"], inline=0,
                batch_frames=c["batch_frames"])


def planes_shared(procs, store_url, store, client, device) -> dict:
    """Leg (d): two ``--shared`` resident dispatchers on one store and the
    one card, each with its own fleet; 400 calls; once half are announced
    the one that placed more and its fleet are SIGKILLed (as
    test_shared_dispatchers.py kills one that owns work, with its fleet).
    Every call runs to COMPLETED exactly once: one terminal record with its
    value, one announce; both dispatchers placed calls."""
    from tpu_faas_torch.workloads import sleep_task

    flags = ("--shared", "--lease-timeout", str(PLANES_LEASE_S),
             "--rescan", str(PLANES_RESCAN_S))
    fleets = [planes_fleet(procs, store_url, tag, flags, PLANES_FLEET,
                           device) for tag in ("shared-1", "shared-2")]
    ann = Announces(store)
    try:
        for (names, stats), tag in zip(fleets, ("shared-1", "shared-2")):
            fleet_ready(procs, tag, stats, PLANES_FLEET[0])
        fid = client.register(sleep_task)
        n = PLANES_SHARED_CALLS
        t0 = time.perf_counter()
        handles = client.submit_many(fid, [((PLANES_SHARED_NAP_S,), {})] * n)
        ids = [h.task_id for h in handles]
        deadline = time.monotonic() + STACK_TIMEOUT_S
        while sum(1 for t in ids if t in ann.seen) < n // 2:
            procs.check()
            assert time.monotonic() < deadline, "shared: half never served"
            time.sleep(0.01)
        # the victim is the one that placed more so far (claims race, and
        # one may have won nearly all of them), as test_shared_dispatchers
        # kills the one that owns work
        placed = [http_json(stats + "/stats")["n_dispatched"]
                  for _, stats in fleets]
        (victims, vstats), (_, sstats) = (
            fleets[i] for i in sorted((0, 1), key=lambda i: -placed[i]))
        before_kill = b1_counts(vstats)
        for name in victims:
            procs.kill(name)
        vals = [h.result(timeout=STACK_TIMEOUT_S) for h in handles]
        t1 = time.perf_counter()
        assert vals == [PLANES_SHARED_NAP_S] * n, "shared: values"
        lat = served(store, ids, [PLANES_SHARED_NAP_S] * n, "shared")
        ann.once(ids, "shared")
        procs.check()
        survivor = b1_counts(sstats)
        out = dict(leg="d", **leg_numbers(lat, t1 - t0),
                   killed_dispatched=before_kill["dispatched"],
                   survivor_dispatched=survivor["dispatched"],
                   launches=[before_kill["launches"], survivor["launches"]],
                   ticks=[before_kill["ticks"], survivor["ticks"]],
                   tick_backend=survivor["tick_backend"], inline=0,
                   batch_frames=0)
        assert out["killed_dispatched"] > 0 and out[
            "survivor_dispatched"] > 0, out
        assert out["launches"] == out["ticks"] and min(out["ticks"]) > 0, out
        return out
    finally:
        ann.close()
        for names, _ in fleets:
            procs.stop([m for m in names if m in procs.procs])


def planes_run(device: str, logdir: str, card: str = "") -> list[dict]:
    """The store server and the gateway, then legs (a)-(d), every process
    through the port's entry points, driven by the port's ``FaaSClient``
    over REST; every child is reaped."""
    import socket

    from tpu_faas_torch.client import FaaSClient
    from tpu_faas_torch.store.launch import make_store

    root = os.path.dirname(os.path.abspath(__file__))
    procs = StackProcesses(root, logdir)
    store = None
    out = []
    try:
        store_port, gw_port = free_port(), free_port()
        procs.start("store", "tpu_faas_torch.store.server", "--port",
                    str(store_port))
        store_url = f"resp://127.0.0.1:{store_port}"

        def store_up() -> bool:
            with socket.create_connection(("127.0.0.1", store_port), 1):
                return True

        wait_until("store server", store_up, procs)
        procs.start("gateway", "tpu_faas_torch.gateway", "--host",
                    "127.0.0.1", "--port", str(gw_port), "--store",
                    store_url)
        base = f"http://127.0.0.1:{gw_port}"
        wait_until("gateway", lambda: http_json(base + "/healthz"), procs)
        store = make_store(store_url)
        client = FaaSClient(base)
        out.append(planes_express(procs, store_url, store, client, device))
        names, stats = planes_fleet(procs, store_url, "plain", (),
                                    PLANES_FLEET, device)
        ann = Announces(store)
        try:
            fleet_ready(procs, "plain", stats, PLANES_FLEET[0])
            out.append(planes_priority(procs, store, client, stats, ann))
            out.append(planes_terminals(procs, store, client, stats, ann))
        finally:
            ann.close()
            procs.stop(names)
        out.append(planes_shared(procs, store_url, store, client, device))
        procs.check()
    finally:
        if store is not None:
            store.close()
        procs.stop()
    for r in out:
        log(planes_text(r, card))
    return out


def planes_text(r: dict, card: str) -> str:
    head = {"a": "leg (a) express lane and batched data plane "
                 "(--express --batch-max 16 --batch-window-ms 2, 4 workers "
                 "x 4, batches of 100 each collected by wait_many)",
            "b": "leg (b) priority hints (2 workers x 2, 200 priority-0 "
                 "sleeps of 100 ms, then 20 priority-9)",
            "c": "leg (c) cancel, timeout and poison (on (b)'s dispatcher; "
                 "B1's counts over legs (b)-(c))",
            "d": "leg (d) two --shared resident dispatchers on one store and "
                 "the one card (two processes on one card, not two cards), "
                 "one SIGKILLed with its fleet halfway"}[r["leg"]]
    extra = ""
    if r["leg"] == "b":
        extra = (f"; every priority-9 call started before the priority-0 "
                 f"calls still queued when it was submitted (at least "
                 f"{r['queued']} each, {r['pairs']} pairs)")
    elif r["leg"] == "c":
        extra = (f"; terminal states {r['states']} as the JAX tests "
                 f"assert, no other call lost")
    elif r["leg"] == "d":
        extra = (f"; dispatched {r['killed_dispatched']} (killed) and "
                 f"{r['survivor_dispatched']} (survivor)")
    valued = "" if r["leg"] == "c" else " with its value"
    return (f"phase planes, {head}: {r['calls']} calls, every one answered "
            f"once{valued}; {r['served_per_s']:.1f} served/s, "
            f"submit-to-result median {r['p50_ms']:.2f} ms, p99 "
            f"{r['p99_ms']:.2f} ms (store stamps); B1 launched "
            f"{r['launches']} times in {r['ticks']} resident ticks "
            f"(tick_backend {r['tick_backend']}); inline deliveries "
            f"{r['inline']}, TASK_BATCH frames {r['batch_frames']}{extra} "
            f"[{card}]")


def phase_planes(card: str) -> dict:
    """The dispatcher's opt-in planes as separate processes on the card
    machine (legs (a)-(d) of :func:`planes_run`). Logs under
    chiprun_out/planes/."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    legs = planes_run("cuda", os.path.join(root, "chiprun_out", "planes"),
                      card=card)
    log(f"phase planes: {time.perf_counter() - t0:.1f} s")
    # each dispatcher process's whole count: (a)'s, (b)-(c)'s (leg (c)
    # reads it after both), (d)'s killed one (before the kill) and survivor
    per = []
    for r in legs:
        if r["leg"] != "b":
            both = (r["launches"], r["ticks"])
            per += (list(zip(*both)) if isinstance(r["ticks"], list)
                    else [both])
    return dict(legs=legs, launches=[a for a, _ in per],
                ticks=[b for _, b in per])


# -- phase 17: the static analysers and the bindings ---------------------------
#: run in a fresh interpreter: the gate over the port's package, as JSON,
#: with what the analysers loaded and the suppression inventory
ANALYSIS_CHILD = r"""
import contextlib, io, json, sys
from pathlib import Path
import tpu_faas_torch
from tpu_faas_torch.analysis import ALL_CHECKERS
from tpu_faas_torch.analysis.__main__ import main
from tpu_faas_torch.analysis.core import Module, iter_py_files
pkg = Path(tpu_faas_torch.__file__).parent
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = main(["--json", str(pkg)])
files = iter_py_files([pkg])
inventory = []
for path, anchor in files:
    text = path.read_text(encoding="utf-8")
    mod = Module.parse(path, path.relative_to(anchor).as_posix(), text)
    lines = text.splitlines()
    for line, tokens in sorted(mod.allows.items()):
        if tokens & {"trace.host-sync", "trace", "*"}:
            why = lines[line - 1].split("faas: allow(", 1)[1]
            inventory.append([mod.relpath, line, why.split(")", 1)[1].strip()])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("torch", "jax", "jaxlib", "tpu_faas"))
print(json.dumps(dict(rc=rc, findings=json.loads(out.getvalue()),
                      checkers=len(ALL_CHECKERS), files=len(files),
                      inventory=inventory, loaded=loaded)))
"""


def phase_analysis(card: str) -> dict:
    """The port's analysers over its own package in a fresh interpreter
    (exit 0, no finding, no torch loaded), then every symbol the wrappers
    bind against the built libraries and the parsed C signatures."""
    import ctypes

    from tpu_faas_torch.analysis import KernelParityChecker
    from tpu_faas_torch.analysis.core import Module
    from tpu_faas_torch.build import library_path
    from tpu_faas_torch.sched import bid, fused_tick

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", ANALYSIS_CHILD], cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["findings"] == [], res["findings"][:20]
    assert res["loaded"] == [], f"the analysers loaded {res['loaded'][:5]}"
    log(f"phase analysis: python -m tpu_faas_torch.analysis over "
        f"tpu_faas_torch/: {res['checkers']} checkers, {res['files']} files, "
        f"0 errors, 0 warnings, exit 0; no torch, JAX or JAX package module "
        f"loaded; {len(res['inventory'])} trace.host-sync suppressions, the "
        f"host syncs on the card's path:")
    for rel, line, why in res["inventory"]:
        log(f"  {rel}:{line}  {why}")
    # the bindings: the source as kernelparity reads it, against the
    # libraries the build phase built and the function objects the
    # wrappers loaded from them
    checker = KernelParityChecker()
    for rel in ("sched/resident.py", "sched/fused_tick.py", "sched/bid.py"):
        path = os.path.join(root, "tpu_faas_torch", *rel.split("/"))
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        list(checker.check(Module.parse(Path(path), rel, src)))
    assert list(checker.finalize()) == []
    libs = {name: ctypes.CDLL(str(library_path(name)))
            for name in ("fused_tick", "bid_top2")}
    loaded = {}
    for obj in (fused_tick.KERNEL, bid.KERNEL):
        for v in vars(obj).values():
            if isinstance(v, ctypes._CFuncPtr):
                loaded[v.__name__] = v
    bound = sorted({b.symbol for b in checker.bindings}
                   | {launch.symbol for launch in checker.launches})
    assert bound and set(bound) <= set(loaded), sorted(set(bound) - set(loaded))
    for sym in bound:
        where = [n for n, lib in libs.items() if hasattr(lib, sym)]
        assert where, f"{sym} is in no built library"
        n_c = len(checker.c_sigs[sym].params)
        n_py = len(loaded[sym].argtypes or ())
        assert n_py == n_c, f"{sym}: argtypes {n_py}, C parameters {n_c}"
    counts = ", ".join(f"{sym} {len(loaded[sym].argtypes or ())}"
                       for sym in bound)
    log(f"  bindings: {len(bound)} symbols bound by the wrappers, each in "
        f"its built library (fused_tick, bid_top2), argtypes as long as the "
        f"parsed extern \"C\" parameter list: {counts}")
    log(f"phase analysis: {time.perf_counter() - t0:.1f} s [{card}]")
    return dict(inventory=res["inventory"], symbols=bound)


# -- phase bench: the port's bench configs through its CLI --------------------
#: the configs the bench phase runs, in order: config 4 (Sinkhorn at the
#: headline shape), 7 (B2 against its plain version at 51,200 x 32,768),
#: 15 (the tick ladder with B1, its rank and auction dry runs) and 1
#: (BASELINE's push sleep through the harness and the port's processes)
BENCH_CONFIGS = ("4", "7", "15", "1")
BENCH_TIMEOUT_S = 420
#: B1's rank branch beyond the headline shape, at config 15's own recipe:
#: the ladder's larger shape and the rank dry run's, (T, W, ticks after
#: the warm-up); each launch is replayed through the plain version
BENCH_B1_SHAPES = ((200_000, 16_384, 2), (500_000, 32_768, 1))


def bench_config(key: str, logdir: str) -> tuple[dict, int, float]:
    """``python -m tpu_faas_torch.bench --config KEY`` on the card (the
    CLI's default device), in a session of its own whose group is killed
    after it: (its one JSON line, its exit code, seconds). Its stderr goes
    to ``<logdir>/config_<key>.err``."""
    import signal

    t0 = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    err_path = os.path.join(logdir, f"config_{key}.err")
    with open(err_path, "w") as err:
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_faas_torch.bench", "--config", key],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=err, text=True,
            start_new_session=True)
        try:
            out, _ = p.communicate(timeout=BENCH_TIMEOUT_S)
        finally:
            try:  # the config's workers, dispatchers and their helpers
                os.killpg(p.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            p.wait()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        with open(err_path) as fh:
            tail = fh.read()[-3000:]
        raise AssertionError(f"config {key}: {len(lines)} JSON lines, exit "
                             f"{p.returncode}:\n{out[-2000:]}\n{tail}")
    return json.loads(lines[0]), p.returncode, time.perf_counter() - t0


def bench_failures(key: str, rec: dict, rc: int) -> list[str]:
    """Why a config's line fails the phase (empty: it passes)."""
    bad = [f"{k}: {rec[k]}" for k in rec
           if (k == "error" or k.endswith("_error")) and rec[k]]
    if rc != 0:
        bad.append(f"exit {rc}")
    if rec.get("device") != "cuda" or not rec.get("card"):
        bad.append(f"not labelled as the card's: {rec.get('device')!r}")
    if bad:
        return bad
    if key == "4" and not rec["makespan_vs_lp_bound"] <= 1.05:
        bad.append(f"makespan/LP {rec['makespan_vs_lp_bound']} > 1.05")
    if key == "7":
        if rec.get("cuda_ms_per_round") is None:
            bad.append("no kernel time")
        if not rec["launches"].get("b2"):
            bad.append("B2 never launched")
    if key == "15":
        bad += [f"row {r['tasks']} x {r['workers']}: not one dispatch a "
                "tick" for r in rec["shapes"] if not r["one_dispatch_per_tick"]]
        for leg in ("dryrun_500k", "auction_dryrun"):
            d = rec[leg]
            if not (d and d["ok"] and d["one_dispatch_per_tick"]):
                bad.append(f"{leg}: {d}")
        if not rec["metrics_scrape_ok"]:
            bad.append(f"exposition: {rec['metrics_missing']}")
        if not rec["launches"].get("b1"):
            bad.append("B1 never launched")
    if key == "1" and rec["correctness_rate"] < 1.0:
        bad.append(f"correctness {rec['correctness_rate']}")
    return bad


def bench_b1_checks(dev) -> dict:
    """B1's rank branch against its plain version at config 15's shapes
    past the headline (``BENCH_B1_SHAPES``), loaded by the config's own
    recipe (``bench/configs.py::_tick_leg``: a mirror fleet of 8 slots a
    worker, the pending buffer bulk-loaded, KA/2 arrivals a tick): every
    launch, the warm-up's included, replayed from its pre-state through
    the plain version, every output and state leaf exactly equal."""
    import itertools

    from tpu_faas_torch.bench.configs import _resident_fleet

    Checked = checked_class()
    out = {"mismatches": 0, "max_abs_err": 0.0, "launches": 0, "shapes": []}
    for T, W, n_ticks in BENCH_B1_SHAPES:
        t0 = time.perf_counter()
        rng = np.random.default_rng(15 + T)
        rs = Checked(max_workers=W, max_pending=T,
                     max_inflight=min(4 * W * 8, 1 << 17), max_slots=8,
                     placement="rank", device=dev)
        _resident_fleet(rs, W, 8)
        n_load = min(T, max(T - rs.KA * (n_ticks + 1), (T + 1) // 2))
        rs.pending_bulk_load([f"t{i}" for i in range(n_load)],
                             rng.uniform(0.1, 5.0, n_load).astype(np.float32))
        seq = itertools.count(n_load)
        placed = bad = launches = 0
        err = 0.0
        for tick in range(n_ticks + 1):
            if tick:
                for _ in range(rs.KA // 2):
                    rs.pending_add(f"t{next(seq)}", 1.0)
            rs.tick_resident()
            log_ = rs.launch_log
            b, e = replay_plain(rs, log_[0][2], log_)
            bad, err, launches = bad + b, max(err, e), launches + len(log_)
            while (res := rs.resolve_next()) is not None:
                placed += len(res.placed)
        log(f"  B1 rank at {T:,} x {W:,} (config 15's recipe): {launches} "
            f"launches in {n_ticks + 1} ticks, {placed} placed, each "
            f"launch against its plain version: {bad} mismatches, max abs "
            f"err {err} ({time.perf_counter() - t0:.1f} s)")
        out["mismatches"] += bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["launches"] += launches
        out["shapes"].append((T, W, launches, placed, bad))
        del rs
        torch.cuda.empty_cache()
    return out


def phase_bench(dev, card: str) -> dict:
    """Each config of ``BENCH_CONFIGS`` through ``python -m
    tpu_faas_torch.bench --config N`` at its own shapes, held by
    :func:`bench_failures`; then :func:`bench_b1_checks`. Prints each
    line's numbers and the phase's seconds; children's stderr under
    chiprun_out/bench/."""
    t0 = time.perf_counter()
    logdir = os.path.join(str(Path(__file__).resolve().parent),
                          "chiprun_out", "bench")
    os.makedirs(logdir, exist_ok=True)
    recs, failures = {}, []
    for key in BENCH_CONFIGS:
        rec, rc, secs = bench_config(key, logdir)
        recs[key] = rec
        log(f"phase bench, config {key} ({secs:.1f} s, exit {rc}): "
            f"{json.dumps(rec)}")
        failures += [f"config {key}: {why}"
                     for why in bench_failures(key, rec, rc)]
    assert not failures, failures
    c4, c7, c15, c1 = (recs[k] for k in BENCH_CONFIGS)
    log(f"  config 4: Sinkhorn placement {c4['placement_ms']} ms, "
        f"makespan/LP {c4['makespan_vs_lp_bound']} (greedy "
        f"{c4['greedy_makespan_vs_lp_bound']}), placed {c4['placed']} "
        f"[{card}]")
    log(f"  config 7: B2 {c7['cuda_ms_per_round']} ms a round, plain "
        f"{c7['plain_ms_per_round']} ms; B2 launches {c7['launches']['b2']} "
        f"[{card}]")
    for r in c15["shapes"]:
        log(f"  config 15, {r['tasks']:,} x {r['workers']:,}: fused median "
            f"{r['fused']['median_ms']} ms, plain {r['plain']['median_ms']} "
            f"ms, fused/plain {r['fused_vs_plain']} [{card}]")
    log(f"  config 15 dry runs: rank {c15['dryrun_500k']['tasks']:,} x "
        f"{c15['dryrun_500k']['workers']:,} {c15['dryrun_500k']['tick_ms']} "
        f"ms, auction {c15['auction_dryrun']['tasks']:,} x "
        f"{c15['auction_dryrun']['workers']:,} "
        f"{c15['auction_dryrun']['tick_ms']} ms; B1 launches "
        f"{c15['launches']['b1']} [{card}]")
    log(f"  config 1: {c1['throughput_tps']} tasks/s, mean latency "
        f"{c1['avg_latency_s']} s, correctness {c1['correctness_rate']}, "
        f"{c1['n_tasks']} tasks x {c1['sims']} runs [{card}]")
    checks = bench_b1_checks(dev)
    assert checks["mismatches"] == 0, checks
    log(f"phase bench: {time.perf_counter() - t0:.1f} s [{card}]")
    return {"configs": recs, "b1": checks,
            "b1_launches": c15["launches"]["b1"],
            "b2_launches": c7["launches"]["b2"]}


# -- phase 14: the host layers the dispatcher imports -------------------------
N_HOST_RECORDS = 300


def phase_host() -> dict:
    """Import every module of the port; run the port's store server in
    process and write and read back task records through the port's
    RespStore and MemoryStore; encode and decode a worker message in both
    framings. Nothing of JAX or the JAX package may be loaded."""
    import importlib
    import pkgutil

    import tpu_faas_torch
    from tpu_faas_torch.core.task import FIELD_STATUS, TaskStatus
    from tpu_faas_torch.store.client import RespStore
    from tpu_faas_torch.store.launch import start_store_thread
    from tpu_faas_torch.store.memory import MemoryStore
    from tpu_faas_torch.worker import messages

    names = [m.name for m in pkgutil.walk_packages(tpu_faas_torch.__path__,
                                                   "tpu_faas_torch.")]
    for name in names:
        importlib.import_module(name)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "tpu_faas"))
    assert not loaded, f"the port loaded {loaded[:5]}"
    handle = start_store_thread()
    counts = {}
    try:
        for label, store in (("RespStore", RespStore(port=handle.port)),
                             ("MemoryStore", MemoryStore())):
            ids = [f"host-{k}" for k in range(N_HOST_RECORDS)]
            store.create_tasks([(t, f"F{t}", f"P{t}") for t in ids])
            for t in ids[::2]:
                store.finish_task(t, TaskStatus.COMPLETED, f"R{t}")
            recs = store.hgetall_many(ids)
            for k, (t, rec) in enumerate(zip(ids, recs)):
                want = "COMPLETED" if k % 2 == 0 else "QUEUED"
                assert rec["fn_payload"] == f"F{t}", (label, t)
                assert rec[FIELD_STATUS] == want, (label, t, rec)
            assert store.get_result(ids[0]) == ("COMPLETED", f"R{ids[0]}")
            counts[label] = len(recs)
            store.close()
    finally:
        handle.stop()
    data = dict(task_id="t1", fn_payload="RjE=", param_payload="UDE=",
                timeout=2.5, trace_id="0" * 32)
    for enc in (messages.encode, messages.encode_bin):
        assert messages.decode(enc(messages.TASK, **data)) == (
            messages.TASK, data)
    log(f"phase host: imported {len(names)} modules of the port, none of "
        f"JAX or the JAX package loaded; {counts['RespStore']} task records "
        f"written and read back through RespStore on the port's store "
        f"server, {counts['MemoryStore']} through MemoryStore; a TASK "
        f"message encoded and decoded in both framings")
    return dict(modules=len(names), **counts)


# -- phase 12: the resident tick under the port's TickProfiler ----------------
PROFILE_TICKS = 20
PROFILE_DIR = "tick_profile"


def busy_us(ops: list[dict]) -> float:
    """Microseconds the card was busy with these Chrome-trace device
    operations: the length of the union of their intervals."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in ops):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def graph_card_ms(dev, card: str) -> dict:
    """The graph phase's batch ticks again, each captured by the port's
    TickProfiler: the card time of a tick is the union of the device
    operations it issued, so the auction's and Sinkhorn's host syncs, which
    CUDA events between a tick's ends include, drop out."""
    from tpu_faas_torch.obs import MetricsRegistry
    from tpu_faas_torch.obs import profile as prof

    os.environ[prof.PROFILE_DIR_ENV] = PROFILE_DIR
    os.environ[prof.PROFILE_TICKS_ENV] = str(GRAPH_TIMED)
    sizes, lanes, _ = graph_batch()
    out = {}
    for placement in ("rank", "auction", "sinkhorn"):
        for on in (False, True):
            kw = lanes if on else {}
            arr = graph_arrays(dev, placement)
            arr.tick(sizes, **kw)  # warm-up
            profiler = prof.TickProfiler(MetricsRegistry())
            for _ in range(GRAPH_TIMED):
                torch.cuda.synchronize()
                with profiler.tick_capture():
                    arr.tick(sizes, **kw)
            ticks = prof.device_ops_by_tick(profiler.trace_path)
            assert len(ticks) == GRAPH_TIMED and all(ticks), placement
            out[placement, on] = (
                statistics.median(busy_us(t) for t in ticks) / 1e3,
                statistics.mean(len(t) for t in ticks))
        (off, n_off), (on_, n_on) = out[placement, False], out[placement, True]
        log(f"  {placement} batch tick, card busy by the capture (the union "
            f"of its device operations), median of {GRAPH_TIMED}: graph "
            f"lanes off {off:.4f} ms ({n_off:.0f} operations), on "
            f"{on_:.4f} ms ({n_on:.0f}) [{card}]")
    return out


def capture_launches(trace_path: str, launches: list[int]) -> float:
    """Hold a TickProfiler capture to the wrapper's counts: each captured
    tick must hold as many B1 kernels (``fused_*``) as the wrapper launched
    in it (``launches``, one entry a tick). A kernel belongs to the tick
    whose span holds its launch call's start, so the result is the least
    time (us) from a B1 launch call to the end of its span. On a
    difference, log every B1 kernel that no tick claims, with its launch
    call's place against the nearest span, then fail."""
    from tpu_faas_torch.obs import profile as prof

    ticks = prof.device_ops_by_tick(trace_path)
    spans = prof.tick_spans(trace_path)
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    calls = {e["args"].get("correlation"): e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    got = [sum("fused_" in e["name"] for e in ops) for ops in ticks]
    if got == launches:
        return min(end - calls[e["args"]["correlation"]]["ts"]
                   for (_, end), ops in zip(spans, ticks) for e in ops
                   if "fused_" in e["name"])
    # the External id torch.profiler gives a span and the calls under it
    span_ext = {e["ts"]: e["args"].get("External id") for e in events
                if e.get("name") == prof.TICK_SPAN}
    claimed = {(e["ts"], e["name"]) for ops in ticks for e in ops}
    for e in events:
        if (e.get("cat") != "kernel" or "fused_" not in e["name"]
                or (e["ts"], e["name"]) in claimed):
            continue
        call = calls.get(e["args"].get("correlation"))
        where = "no launch call in the capture"
        if call is not None:
            k = min(range(len(spans)), key=lambda i: min(
                abs(call["ts"] - spans[i][0]), abs(call["ts"] - spans[i][1])))
            where = (f"{call['name']} at {call['ts'] - spans[k][0]:.3f} us "
                     f"from tick {k}'s start, {call['ts'] - spans[k][1]:.3f}"
                     f" us from its end (span {spans[k][1] - spans[k][0]:.3f}"
                     f" us; External id {call['args'].get('External id')},"
                     f" the span's {span_ext.get(spans[k][0])})")
        log(f"  UNCLAIMED {e['name'].split('(', 1)[0]} at {e['ts']}: {where}")
    # keep the capture beside the run's other outputs (git-ignored)
    import shutil

    os.makedirs("chiprun_out", exist_ok=True)
    kept = shutil.copy(trace_path, "chiprun_out")
    raise AssertionError(f"capture {trace_path} (kept as {kept}): B1 kernels "
                         f"a tick {got}, the wrapper launched {launches}")


def capture_split(trace_path: str, kernel: str) -> dict:
    """One TickProfiler capture read back (times in ms), every tick of it
    holding a launch of the kernel whose name holds ``kernel``: those
    launches and their mean time; the mean device idle between one tick's
    last device operation and the next tick's first; inside each steady
    tick's span (every tick but the first, which pays the capture's start)
    the host's work before its first device operation, the device's wait
    between the operation before the first such launch and that launch,
    and the host's work after that launch ends; the host's time between
    spans; and the card's busy share of the window from the first tick's
    first operation to the last tick's last."""
    from tpu_faas_torch.obs import profile as prof

    ticks = prof.device_ops_by_tick(trace_path)
    spans = prof.tick_spans(trace_path)
    b1 = [e["dur"] for ops in ticks for e in ops if kernel in e["name"]]
    gaps = [nxt[0]["ts"] - max(e["ts"] + e["dur"] for e in cur)
            for cur, nxt in zip(ticks, ticks[1:])]
    inside = []
    for (s0, s1), ops in list(zip(spans, ticks))[1:]:
        k = next((i for i, e in enumerate(ops) if kernel in e["name"]), None)
        assert k is not None, f"a captured tick without {kernel}"
        before = (max(e["ts"] + e["dur"] for e in ops[:k]) if k
                  else ops[k]["ts"])
        inside.append((ops[0]["ts"] - s0, ops[k]["ts"] - before,
                       s1 - (ops[k]["ts"] + ops[k]["dur"]), s1 - s0))
    lead, wait, tail, span = (statistics.mean(c) / 1e3
                              for c in zip(*inside))
    host_gap = statistics.mean(b[0] - a[1] for a, b in zip(spans, spans[1:]))
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    lo = ticks[0][0]["ts"]
    hi = max(e["ts"] + e["dur"] for e in ticks[-1])
    busy = busy_us([e for e in events
                    if e.get("cat") in prof.DEVICE_CATEGORIES
                    and lo <= e["ts"] < hi])
    return dict(ticks=len(ticks), steady=len(inside), b1=len(b1),
                b1_ms=statistics.mean(b1) / 1e3,
                gap_ms=statistics.mean(gaps) / 1e3, busy=busy / (hi - lo),
                window_ms=(hi - lo) / 1e3,
                ops=statistics.mean(len(t) for t in ticks), lead_ms=lead,
                wait_ms=wait, tail_ms=tail, span_ms=span,
                host_gap_ms=host_gap / 1e3)


def phase_profile(dev, card: str) -> dict:
    """The headline rank loop (phase 2's loop and checks, shortened) with
    its timed ticks captured by the port's TickProfiler on
    torch.profiler: B1's mean kernel time, the mean device idle between
    one tick's last device operation and the next tick's first, and the
    card's busy share of the window from the first tick's first operation
    to the last tick's last."""
    from tpu_faas_torch.obs import MetricsRegistry, render
    from tpu_faas_torch.obs import profile as prof
    from tpu_faas_torch.sched.fused_tick import KERNEL

    os.environ[prof.PROFILE_DIR_ENV] = PROFILE_DIR
    os.environ[prof.PROFILE_TICKS_ENV] = str(PROFILE_TICKS)
    reg = MetricsRegistry()
    profiler = prof.TickProfiler(reg)
    KERNEL.launches = 0  # count this path alone
    rr = phase_resident(dev, 24, PROFILE_TICKS, profiler=profiler)
    launches = KERNEL.launches
    assert launches > 0, "the profiled loop never launched B1"
    assert profiler.trace_path is not None, "no capture was written"
    margin = capture_launches(profiler.trace_path, rr["timed_launches"])
    cap = capture_split(profiler.trace_path, "fused_rank_kernel")
    assert cap["ticks"] == PROFILE_TICKS, cap["ticks"]
    assert cap["steady"] == PROFILE_TICKS - 1, cap["steady"]
    text = render([reg])
    assert f"tpu_faas_device_ticks_total {PROFILE_TICKS}" in text
    out = dict(tick_ms=statistics.median(rr["tick_ms"]), launches=launches,
               **{k: cap[k] for k in (
                   "b1_ms", "gap_ms", "busy", "window_ms", "ops", "lead_ms",
                   "wait_ms", "tail_ms", "span_ms", "host_gap_ms")})
    log(f"phase profile: TickProfiler captured {PROFILE_TICKS} resident rank "
        f"ticks ({profiler.trace_path}, {out['ops']:.1f} device operations "
        f"a tick); B1 (fused_rank_kernel) mean {out['b1_ms']:.4f} ms over "
        f"{cap['b1']} launches; mean device idle between one tick's last "
        f"operation and the next tick's first {out['gap_ms']:.4f} ms; the "
        f"card busy {100 * out['busy']:.2f}% of the {out['window_ms']:.3f} ms "
        f"window; integrated tick under capture {out['tick_ms']:.4f} ms "
        f"(median); B1 launches in the loop {launches}, every captured tick "
        f"holding the one the wrapper counted, the closest launch call "
        f"{margin:.3f} us before its span's end [{card}]")
    log(f"  inside a steady tick's span ({out['span_ms']:.4f} ms, means of "
        f"{cap['steady']}): host work before its first device operation "
        f"{out['lead_ms']:.4f} ms, the device waiting between the packet "
        f"upload's end and B1's start {out['wait_ms']:.4f} ms, host work "
        f"after B1 ends {out['tail_ms']:.4f} ms; between spans (the loop's "
        f"results, heartbeats, arrivals and resolves) "
        f"{out['host_gap_ms']:.4f} ms [{card}]")
    return out


# -- phase 15: multi-device scheduling (tpu_faas_torch/parallel) --------------
MESH_POSITIONS = 4
#: (a)'s single tick per placement, route and layout: the positions as
#: ``_device_runs`` gives them (one run on the one card), or each a run of
#: its own (the layout of a process whose positions each have a card)
MESH_CASES = (("rank", "gspmd", False), ("auction", "gspmd", False),
              ("auction", "permute", False), ("auction", "permute", True),
              ("sinkhorn", "gspmd", False))
#: Sinkhorn's sharded dense plan against the single-device tick's: JAX's own
#: pin (tests/test_parallel_mesh.py:64-86)
MESH_COST_RTOL = 0.05
#: (b)'s lockstep churn: ticks, arrivals and results a tick, the tick that
#: silences MESH_SILENT workers (the clock then jumps past time_to_expire)
MESH_CHURN_TICKS, MESH_CHURN, MESH_SILENCE_AT, MESH_SILENT = 40, 256, 25, 64
#: (c)'s ticks of each leg and (d)'s requests, in bursts of at most 16
#: (ROADMAP C.5)
MH_TICKS = 20
#: (c)'s max_pending: odd, so the 2-position mesh pads it to SHAPE["T"]
MH_PENDING = SHAPE["T"] - 1
MH_REQUESTS, MH_BURST, MH_WORKERS = 64, 16, 4
MH_TIMEOUT_S = 240
#: (c)'s Sinkhorn ticks across the two processes: the scripted tick's
#: collectives call back into Python for gloo's gathers (ROADMAP C.11)
MH_SK_TICKS = 2


def mesh_tick_inputs(seed: int, n_valid: int | None = None):
    """One headline tick's host inputs: sizes, valid, priorities [T];
    speed, free, active, heartbeat ages (some past time_to_expire),
    prev_live [W]; the in-flight table [I]."""
    T, W, I = SHAPE["T"], SHAPE["W"], SHAPE["I"]
    rng = np.random.default_rng(seed)
    sizes = rng.uniform(0.1, 10.0, T).astype(np.float32)
    if n_valid is None:
        valid = rng.random(T) < 0.9
    else:
        valid = np.arange(T) < n_valid
    prio = rng.integers(0, 4, T).astype(np.int32)
    speed = rng.uniform(0.5, 4.0, W).astype(np.float32)
    free = rng.integers(0, MAX_SLOTS + 1, W).astype(np.int32)
    active = rng.random(W) > 0.02
    hb_age = rng.uniform(0.0, 10.5, W).astype(np.float32)
    prev_live = rng.random(W) > 0.01
    inflight = rng.integers(-1, W, I).astype(np.int32)
    return dict(sizes=sizes, valid=valid, prio=prio, speed=speed, free=free,
                active=active, hb_age=hb_age, prev_live=prev_live,
                inflight=inflight)


def digest(*arrays) -> int:
    import zlib

    crc = 0
    for a in arrays:
        a = a if isinstance(a, np.ndarray) else a.detach().cpu().numpy()
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


def torch_calls(fn) -> int:
    """The torch calls ``fn()`` makes from Python, each a release and
    retake of the interpreter lock around its op (a ``TorchFunctionMode``
    sees no op inside a scripted call)."""
    from tpu_faas_torch.sched.scripted import CallCount

    with CallCount() as calls:
        fn()
    return calls.n


def sinkhorn_contract(a, b, x) -> str:
    """A sharded Sinkhorn assignment ``a`` against the single-device tick's
    ``b`` on the inputs ``x``: the same count placed, no row over-booked, no
    invalid row placed, a cost within MESH_COST_RTOL; returns the detail."""
    assert (a >= 0).sum() == (b >= 0).sum(), (a >= 0).sum()
    cap = np.where(x["active"] & (x["hb_age"] <= 10.0),
                   np.minimum(x["free"], MAX_SLOTS), 0)
    use = np.bincount(a[a >= 0], minlength=SHAPE["W"])
    assert (use <= cap).all(), "a row over-booked"
    assert not ((a >= 0) & ~x["valid"]).any(), "an invalid row placed"
    cost = float((x["sizes"][a >= 0] / x["speed"][a[a >= 0]]).sum())
    ref = float((x["sizes"][b >= 0] / x["speed"][b[b >= 0]]).sum())
    assert abs(cost - ref) <= MESH_COST_RTOL * ref, (cost, ref)
    return (f"{int((a >= 0).sum())} placed by both, cost {cost:.3f} against "
            f"the single tick's {ref:.3f} ({100 * (cost / ref - 1):+.3f}%), "
            f"no row over-booked")


@contextlib.contextmanager
def runs_of_one(tm):
    """Each position of a mesh a run of its own while active: the permute
    auction then bids each position with B2 at its own row offset and the
    ring resolves the winners across the positions, as in a process whose
    positions each have a card."""
    runs = tm._device_runs
    tm._device_runs = lambda m: [(i, i + 1, d)
                                 for i, d in enumerate(m.devices)]
    try:
        yield
    finally:
        tm._device_runs = runs


def mesh_one_card(dev, card: str) -> dict:
    """(a) sharded_scheduler_tick over MESH_POSITIONS positions named on
    the one card against the single-device tick on the same inputs."""
    from tpu_faas_torch.parallel import mesh as tm
    from tpu_faas_torch.sched import bid
    from tpu_faas_torch.sched.state import scheduler_tick_impl

    mesh = tm.make_mesh(devices=[dev] * MESH_POSITIONS)
    log(f"phase mesh (a): one process, {mesh.size} positions named on the "
        f"one card, an explicit device list {[str(d) for d in mesh.devices]}"
        f" (positions, not cards)")
    x = mesh_tick_inputs(51)
    ts, tv, tp = tm.shard_task_arrays(mesh, x["sizes"], x["valid"],
                                      x["prio"])
    full = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    fleet = [full[k] for k in ("speed", "free", "active", "hb_age",
                               "prev_live", "inflight")]
    out = dict(b2=[])
    for placement, route, each in MESH_CASES:
        prio_kw = placement == "rank"
        label = f"{route}, runs of one" if each else route

        def sharded():
            with runs_of_one(tm) if each else contextlib.nullcontext():
                return tm.sharded_scheduler_tick(
                    mesh, ts, tv, *fleet, 10.0, max_slots=MAX_SLOTS,
                    placement=placement,
                    task_priority=tp if prio_kw else None,
                    winner_resolve=route)

        def single():
            return scheduler_tick_impl(
                full["sizes"], full["valid"], *fleet, 10.0,
                max_slots=MAX_SLOTS,
                task_priority=full["prio"] if prio_kw else None,
                placement=placement)

        sharded(), single()  # warm-up: the first call of each op pays more
        torch.cuda.synchronize()
        bid.KERNEL.launches = 0  # count the sharded tick alone
        t0 = time.perf_counter()
        got = sharded()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        b2 = bid.KERNEL.launches
        t0 = time.perf_counter()
        want = single()
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0)
        a = got.assignment.cpu().numpy()
        for f in ("live", "purged", "redispatch"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (
                placement, label, f)
        calls = torch_calls(sharded)
        torch.cuda.synchronize()
        if placement == "sinkhorn":
            detail = sinkhorn_contract(a, want.assignment.cpu().numpy(), x)
        else:
            assert torch.equal(got.assignment, want.assignment), (
                placement, label)
            detail = f"{int((a >= 0).sum())} placed, every output equal"
            if placement == "auction":
                assert got.auction_rounds == want.auction_rounds
                assert torch.equal(got.auction_price, want.auction_price)
                assert bool(got.auction_refresh) == bool(want.auction_refresh)
                # the permute route bids each run of positions on one
                # device as one block: one launch a round on the one card,
                # or one a position where each is a run of its own
                per = 1
                if route == "permute":
                    per = mesh.size if each else len(tm._device_runs(mesh))
                assert b2 == per * got.auction_rounds, (b2, got.auction_rounds)
                out["b2"].append(b2)
                detail += (f", prices and {got.auction_rounds} rounds equal; "
                           f"B2 launches {b2} = {per} launch"
                           f"{'es' if per > 1 else ''} a round x "
                           f"{got.auction_rounds} rounds")
        out[placement, label] = ms
        out["calls", placement, label] = calls
        log(f"  {placement} ({label}): sharded tick {ms:.3f} ms, the "
            f"single-device tick {one_ms:.3f} ms (host clock, synchronized; "
            f"one call each after one untimed); torch calls from Python "
            f"{calls} a sharded tick (a TorchFunctionMode, one more call); "
            f"{detail} [{card}]")
    return out


def scripted_rank_tick(dev, card: str) -> dict:
    """(a') The single-device rank batch tick with no plane or graph lane,
    one scripted call (``sched/state.py::_rank_tick``, ROADMAP C.12),
    against ``scheduler_tick_impl`` run eagerly on the same headline
    inputs, FCFS and with priorities: every output equal; both timed in
    turns (scripted, eager, scripted, eager), 20 ticks each, synchronized,
    on the host clock."""
    from tpu_faas_torch.sched.state import packed_tick, scheduler_tick_impl

    T, W = SHAPE["T"], SHAPE["W"]
    x = mesh_tick_inputs(53, n_valid=40_000)
    n = 40_000
    sizes = x["sizes"].copy()
    sizes[n:] = 0.0
    packed = torch.from_numpy(np.concatenate(
        [sizes, x["hb_age"], x["free"].astype(np.float32)])).to(dev)
    f = {k: torch.from_numpy(v).to(dev) for k, v in x.items()}
    out = {}
    for label, prio in (("fcfs", None), ("priority", f["prio"])):
        def scripted():
            return packed_tick(packed, n, f["speed"], f["active"],
                               f["prev_live"], f["inflight"], 10.0, prio,
                               T=T, W=W, max_slots=MAX_SLOTS)

        def eager():
            return scheduler_tick_impl(
                packed[:T], torch.arange(T, device=dev) < n, f["speed"],
                packed[T + W:].to(torch.int32), f["active"],
                packed[T:T + W], f["prev_live"], f["inflight"], 10.0,
                max_slots=MAX_SLOTS, task_priority=prio)

        a, b = scripted(), eager()
        for k in ("assignment", "live", "purged", "redispatch"):
            assert torch.equal(getattr(a, k), getattr(b, k)), (label, k)
        ms: dict = {"scripted": [], "eager": []}
        for name, fn in (("scripted", scripted), ("eager", eager)) * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0) / 20)
        calls = torch_calls(scripted)
        out[label] = dict(ms=ms, calls=calls,
                          placed=int((a.assignment >= 0).sum()))
        log(f"phase mesh (a'): the rank batch tick ({label}), one scripted "
            f"call, equal to scheduler_tick_impl run eagerly on every output "
            f"({out[label]['placed']} placed); ms a tick, in turns: scripted "
            f"{[round(t, 4) for t in ms['scripted']]}, eager "
            f"{[round(t, 4) for t in ms['eager']]} (host clock, "
            f"synchronized, 20 ticks each); torch calls from Python {calls} "
            f"[{card}]")
    return out


def mesh_batch_churn(dev) -> dict:
    """(b) SchedulerArrays(mesh_devices=1) and SchedulerArrays() in
    lockstep through MESH_CHURN_TICKS headline ticks: every output equal."""
    from tpu_faas_torch.sched.state import SchedulerArrays

    W, T = SHAPE["W"], SHAPE["T"]
    rng = np.random.default_rng(61)
    clock = [1000.0]
    procs = rng.integers(1, MAX_SLOTS + 1, W)
    speeds = rng.uniform(0.5, 4.0, W)
    kw = dict(max_workers=W, max_pending=T, max_inflight=SHAPE["I"],
              max_slots=MAX_SLOTS, time_to_expire=10.0,
              clock=lambda: clock[0], device=dev)
    both = (SchedulerArrays(**kw), SchedulerArrays(mesh_devices=1, **kw))
    assert both[1].mesh.size == 1
    for a in both:
        for i in range(W):
            a.register(b"w%d" % i, int(procs[i]), speed=float(speeds[i]))
    pending = [(f"b{i}", float(s), int(p)) for i, (s, p) in enumerate(zip(
        rng.uniform(0.1, 10.0, T // 2), rng.integers(0, 4, T // 2)))]
    inflight: dict[str, int] = {}
    silent: set[int] = set()
    n_new, placed = 0, 0
    for tick in range(MESH_CHURN_TICKS):
        clock[0] += 0.005
        if tick == MESH_SILENCE_AT:
            silent = set(int(r) for r in rng.choice(W, MESH_SILENT, False))
            clock[0] += 11.0
            for a in both:
                for r in range(W):
                    if r not in silent and a.worker_active[r]:
                        a.heartbeat(a.row_ids[r])
        done = rng.permutation(sorted(inflight))[:MESH_CHURN]
        for tid in done:
            row = inflight.pop(tid)
            for a in both:
                a.release_slot(a.inflight_done(tid))
        for s, p in zip(rng.uniform(0.1, 10.0, MESH_CHURN),
                        rng.integers(0, 4, MESH_CHURN)):
            if len(pending) < T:
                pending.append((f"n{n_new}", float(s), int(p)))
                n_new += 1
        sizes = np.array([p[1] for p in pending], np.float32)
        prios = np.array([p[2] for p in pending], np.int32)
        outs = [a.tick(sizes, task_priorities=prios) for a in both]
        for f in ("assignment", "live", "purged", "redispatch"):
            assert torch.equal(getattr(outs[0], f), getattr(outs[1], f)), (
                tick, f)
        a0 = both[0]
        redo = np.flatnonzero(outs[0].redispatch.cpu().numpy())
        for slot in redo:
            tid = a0.inflight_task[int(slot)]
            for a in both:
                a.inflight_clear_slot(int(slot))
            inflight.pop(tid, None)
        for row in np.flatnonzero(outs[0].purged.cpu().numpy()):
            for a in both:
                a.deactivate(int(row))
        asg = outs[0].assignment.cpu().numpy()[:len(pending)]
        keep = []
        for (tid, s, p), row in zip(pending, asg):
            if row >= 0 and a0.worker_active[row]:
                for a in both:
                    a.inflight_add(tid, int(row))
                    a.worker_free[row] -= 1
                inflight[tid] = int(row)
                placed += 1
            else:
                keep.append((tid, s, p))
        pending = keep
        assert (a0.worker_free >= 0).all(), "a row over-booked"
    return dict(ticks=MESH_CHURN_TICKS, placed=placed,
                purged=MESH_SILENT)


def mesh_resident_churn(dev) -> dict:
    """(b) ResidentScheduler(mesh_devices=1) and ResidentScheduler() in
    lockstep through MESH_CHURN_TICKS headline ticks: every resolved tick
    equal; B1's launches under the mesh counted by the wrapper."""
    from tpu_faas_torch.sched.fused_tick import KERNEL
    from tpu_faas_torch.sched.resident import ResidentScheduler

    W, T = SHAPE["W"], SHAPE["T"]
    rng = np.random.default_rng(71)
    clock = [1000.0]
    procs = rng.integers(1, MAX_SLOTS + 1, W)
    speeds = rng.uniform(0.5, 4.0, W)
    kw = dict(max_workers=W, max_pending=T, max_inflight=SHAPE["I"],
              max_slots=MAX_SLOTS, time_to_expire=10.0,
              clock=lambda: clock[0], device=dev, use_priority=True)
    both = (ResidentScheduler(**kw), ResidentScheduler(mesh_devices=1, **kw))
    for a in both:
        for i in range(W):
            a.register(b"w%d" % i, int(procs[i]), speed=float(speeds[i]))
    ids = [f"bulk-{i}" for i in range(T)]
    bulk = rng.uniform(0.1, 10.0, T).astype(np.float32)
    bprio = rng.integers(0, 4, T).astype(np.int32)
    for a in both:
        a.pending_bulk_load(ids, bulk, bprio)
    inflight: dict[str, int] = {}
    n_new, placed, mesh_launches, steady = 0, 0, 0, []
    for tick in range(MESH_CHURN_TICKS):
        clock[0] += 0.005
        if tick == MESH_SILENCE_AT:
            silent = set(int(r) for r in rng.choice(W, MESH_SILENT, False))
            clock[0] += 11.0
            for a in both:
                for r in range(W):
                    if r not in silent and a.worker_active[r]:
                        a.heartbeat(a.row_ids[r])
        for tid in rng.permutation(sorted(inflight))[:MESH_CHURN]:
            inflight.pop(tid)
            for a in both:
                a.release_slot(a.inflight_done(tid))
        for s, p in zip(rng.uniform(0.1, 10.0, MESH_CHURN),
                        rng.integers(0, 4, MESH_CHURN)):
            for a in both:
                a.pending_add(f"n{n_new}", float(s), priority=int(p))
            n_new += 1
        both[0].tick_resident()
        KERNEL.launches = 0  # count the tick under the mesh alone
        both[1].tick_resident()
        assert KERNEL.launches == both[1].device_dispatches_last_tick
        mesh_launches += both[1].device_dispatches_last_tick
        steady.append(both[1].device_dispatches_last_tick)
        r0, r1 = both[0].resolve_next(), both[1].resolve_next()
        assert (r0.placed, r0.redispatch_slots, list(r0.purged_rows),
                r0.n_pending, r0.rejected) == (
            r1.placed, r1.redispatch_slots, list(r1.purged_rows),
            r1.n_pending, r1.rejected), f"tick {tick} differs"
        for slot in r0.redispatch_slots:
            tid = both[0].inflight_task[slot]
            for a in both:
                a.inflight_clear_slot(slot)
            inflight.pop(tid, None)
        for row in r0.purged_rows:
            for a in both:
                a.deactivate(int(row))
        for tid, row in r0.placed:
            for a in both:
                a.inflight_add(tid, row)
            inflight[tid] = row
            placed += 1
    last = steady[-(MESH_CHURN_TICKS - MESH_SILENCE_AT - 2):]
    assert last and all(n == 1 for n in last), steady
    for x, y in zip(both[0]._r_state, both[1]._r_state):
        assert torch.equal(x, y), "the states differ"
    return dict(ticks=MESH_CHURN_TICKS, placed=placed,
                launches=mesh_launches, per_tick=steady)


def mesh_child(rank: int, port: int, device: str = "cuda") -> None:
    """(c)'s child: one of two processes on the one card, gloo through host
    memory; runs MH_TICKS ticks of MultihostTick (rank) and then
    MH_TICKS of MultihostResidentScheduler (rank), lead or follower; prints
    one MESHCHILD JSON line."""
    from tpu_faas_torch.parallel import distributed
    from tpu_faas_torch.parallel.multihost_resident import (
        MultihostResidentScheduler,
    )
    from tpu_faas_torch.parallel.multihost_tick import MultihostTick
    from tpu_faas_torch.sched import fused_tick

    assert distributed.initialize_multihost(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank, backend="gloo", timeout=MH_TIMEOUT_S)
    dev = distributed.process_device(device)
    out: dict = dict(rank=rank)
    mt = MultihostTick(max_pending=MH_PENDING, max_workers=SHAPE["W"],
                       max_slots=MAX_SLOTS, placement="rank", device=dev)
    out["positions"] = [f"{r}:{d}" for r, d in mt.mesh.positions]
    out["tick_T"] = mt.T
    times: list = []
    real = mt._broadcast

    def timed(buf):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(buf)
        times.append(1e3 * (time.perf_counter() - t0))
        return res

    mt._broadcast = timed
    digests, tick_ms = [], []
    for k in range(MH_TICKS):
        if rank == 0:
            x = mesh_tick_inputs(500 + k, n_valid=40_000 + 500 * k)
            n = 40_000 + 500 * k
            t0 = time.perf_counter()
            res = mt.lead_tick(x["sizes"][:n], x["speed"], x["free"],
                               x["active"], x["hb_age"], x["inflight"], 10.0,
                               task_priorities=x["prio"][:n])
            tick_ms.append(1e3 * (time.perf_counter() - t0))
            out.setdefault("redispatch", []).append(digest(res.redispatch))
        else:
            res = mt._run(mt._broadcast(np.zeros(mt.buflen, np.float32)))
        digests.append(digest(res.assignment, res.live, res.purged))
    if rank == 0:
        mt.lead_stop()
    else:
        assert mt._run(mt._broadcast(np.zeros(mt.buflen, np.float32))) is None
    out.update(tick_digests=digests, tick_bytes=4 * mt.buflen,
               tick_bcast_ms=statistics.median(times[:MH_TICKS]),
               tick_ms=statistics.median(tick_ms) if tick_ms else None)

    # Sinkhorn across the two processes: each holds one position, and the
    # scripted tick's collectives gather through gloo
    from tpu_faas_torch.sched.state import scheduler_tick_impl

    ms = MultihostTick(max_pending=MH_PENDING, max_workers=SHAPE["W"],
                       max_slots=MAX_SLOTS, placement="sinkhorn", device=dev)
    sk_digests, sk_ms, sk_detail = [], [], []
    prev = torch.zeros(SHAPE["W"], dtype=torch.bool, device=dev)
    for k in range(MH_SK_TICKS):
        n = 40_000 + 500 * k
        x = mesh_tick_inputs(700 + k, n_valid=n)
        if rank == 0:
            t0 = time.perf_counter()
            res = ms.lead_tick(x["sizes"][:n], x["speed"], x["free"],
                               x["active"], x["hb_age"], x["inflight"], 10.0)
            sk_ms.append(1e3 * (time.perf_counter() - t0))
            # the single-device tick on the same inputs (the broadcast
            # buffer's zero padding and the lead's carried prev_live)
            f = {key: torch.from_numpy(v).to(dev) for key, v in x.items()}
            sizes = f["sizes"].clone()
            sizes[n:] = 0.0
            want = scheduler_tick_impl(
                sizes, f["valid"], f["speed"], f["free"], f["active"],
                f["hb_age"], prev,
                torch.full((1,), -1, dtype=torch.int32, device=dev), 10.0,
                max_slots=MAX_SLOTS, placement="sinkhorn")
            prev = want.live
            assert np.array_equal(res.live, want.live.cpu().numpy())
            sk_detail.append(sinkhorn_contract(
                res.assignment, want.assignment.cpu().numpy(), x))
        else:
            res = ms._run(ms._broadcast(np.zeros(ms.buflen, np.float32)))
        sk_digests.append(digest(res.assignment, res.live, res.purged))
    if rank == 0:
        ms.lead_stop()
    else:
        assert ms._run(ms._broadcast(np.zeros(ms.buflen, np.float32))) is None
    out.update(sinkhorn_digests=sk_digests, sinkhorn_detail=sk_detail,
               sinkhorn_tick_ms=sk_ms)

    if dev.type == "cuda":
        fused_tick.KERNEL.load()
    box = [1000.0]
    r = MultihostResidentScheduler.from_shape(
        max_workers=SHAPE["W"], max_pending=MH_PENDING,
        max_inflight=SHAPE["I"], max_slots=MAX_SLOTS, time_to_expire=10.0,
        placement="rank", clock=lambda: box[0], device=dev)
    r._clock_box = box
    out["resident_T"] = r.max_pending
    times.clear()
    real_r = r._broadcast

    def timed_r(buf):
        t0 = time.perf_counter()
        res = real_r(buf)
        times.append(1e3 * (time.perf_counter() - t0))
        return res

    r._broadcast = timed_r
    fused_tick.KERNEL.launches = 0
    if rank == 0:
        out["resolved"] = mh_resident_scenario(r)
        r.lead_stop()
    else:
        r.follow_loop(watchdog_timeout=MH_TIMEOUT_S)
    out.update(state=digest(*r._r_state), b1_launches=fused_tick.KERNEL.launches,
               packet_bytes=4 * r.packet_len(),
               packet_bcast_ms=statistics.median(times),
               packets=len(times))
    print("MESHCHILD " + json.dumps(out), flush=True)
    distributed.shutdown()


def mh_resident_scenario(r) -> list[int]:
    """The resident leg's scenario, the same for the lead and the
    single-process reference: 4,096 workers registered, then MH_TICKS
    ticks of 512 arrivals, 256 results and 128 heartbeats, +5 ms each;
    returns each resolved tick's digest."""
    W = SHAPE["W"]
    rng = np.random.default_rng(81)
    procs = rng.integers(1, MAX_SLOTS + 1, W)
    speeds = rng.uniform(0.5, 4.0, W)
    for i in range(W):
        r.register(b"w%d" % i, int(procs[i]), speed=float(speeds[i]))
    inflight: dict[str, int] = {}
    out, n = [], 0
    for _ in range(MH_TICKS):
        r._clock_box[0] += 0.005
        for i in rng.choice(W, SHAPE["KH"] // 4, replace=False):
            r.heartbeat(b"w%d" % i)
        for tid in rng.permutation(sorted(inflight))[:MESH_CHURN]:
            inflight.pop(tid)
            r.release_slot(r.inflight_done(tid))
        for s, p in zip(rng.uniform(0.1, 10.0, SHAPE["KA"]),
                        rng.integers(0, 4, SHAPE["KA"])):
            r.pending_add(f"m{n}", float(s), priority=int(p))
            n += 1
        r.tick_resident()
        while (res := r.resolve_next()) is not None:
            for tid, row in res.placed:
                r.inflight_add(tid, row)
                inflight[tid] = row
            out.append(digest(np.array([row for _, row in res.placed]),
                              np.array(res.redispatch_slots, np.int64),
                              np.asarray(res.purged_rows),
                              np.array([res.n_pending, res.rejected])))
    return out


def spawn(args: list[str], cwd: str):
    return subprocess.Popen([sys.executable, *args], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def free_port() -> int:
    """A free TCP port below the kernel's ephemeral range, for a server a
    child binds later: a port from bind(0) lies in that range, and the
    kernel may hand it to the next process that binds port 0 or connects
    out before the child binds it (ROADMAP C.7); one below the range is
    taken only by a process that asks for it by number."""
    import random
    import socket

    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            hi = int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        hi = 32768
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(max(1024, hi - 12000), hi)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


def finish(procs, timeout: float = MH_TIMEOUT_S) -> list[str]:
    """Each child's output once it exits 0; every child killed in the end."""
    outs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=timeout)
            outs.append(o)
            assert p.returncode == 0, o[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def mesh_two_processes(dev, card: str) -> dict:
    """(c) two processes on the one card (gloo through host memory, not a
    number for two cards): both ranks agree bit for bit, and the lead
    equals the single-process tick and scheduler."""
    from tpu_faas_torch.sched.resident import ResidentScheduler
    from tpu_faas_torch.sched.state import scheduler_tick_impl

    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs = [spawn(["-c", f"import chip_smoke; chip_smoke.mesh_child({r}, "
                    f"{port}, {dev.type!r})"], root) for r in (0, 1)]
    outs = finish(procs)
    lead, follower = (json.loads(next(
        line.split(" ", 1)[1] for line in o.splitlines()
        if line.startswith("MESHCHILD "))) for o in outs)
    assert lead["tick_digests"] == follower["tick_digests"]
    assert lead["sinkhorn_digests"] == follower["sinkhorn_digests"]
    assert lead["state"] == follower["state"], "the resident replicas differ"
    assert lead["b1_launches"] == follower["b1_launches"] > 0
    # both layouts padded the odd max_pending to the 2-position mesh
    assert lead["tick_T"] == lead["resident_T"] == SHAPE["T"], lead
    # the single process on the same inputs, at the padded shape
    prev = torch.zeros(SHAPE["W"], dtype=torch.bool, device=dev)
    for k in range(MH_TICKS):
        n = 40_000 + 500 * k
        x = mesh_tick_inputs(500 + k, n_valid=n)
        f = {key: torch.from_numpy(v).to(dev) for key, v in x.items()}
        sizes = f["sizes"].clone()
        sizes[n:] = 0.0
        prio = f["prio"].clone()
        prio[n:] = 0
        want = scheduler_tick_impl(
            sizes, f["valid"], f["speed"], f["free"], f["active"],
            f["hb_age"], prev, f["inflight"], 10.0, max_slots=MAX_SLOTS,
            task_priority=prio)
        prev = want.live
        assert digest(want.assignment, want.live, want.purged) == \
            lead["tick_digests"][k], f"tick {k} differs from one process"
        assert digest(want.redispatch) == lead["redispatch"][k]
    box = [1000.0]
    one = ResidentScheduler(
        max_workers=SHAPE["W"], max_pending=SHAPE["T"],
        max_inflight=SHAPE["I"], max_slots=MAX_SLOTS, time_to_expire=10.0,
        use_priority=True, device=dev, clock=lambda: box[0])
    one._clock_box = box
    one._ensure_state()  # before the registrations, as every replica does
    assert mh_resident_scenario(one) == lead["resolved"]
    assert digest(*one._r_state) == lead["state"]
    log(f"phase mesh (c): two processes on the one card, gloo through host "
        f"memory (two processes sharing one card: not a number for two "
        f"cards); positions {lead['positions']}; max_pending {MH_PENDING} "
        f"padded to {lead['resident_T']} by the mesh, held against one "
        f"process at {SHAPE['T']}. MultihostTick, rank, "
        f"{MH_TICKS} ticks: both ranks bit for bit, the lead equal to the "
        f"single-process tick on every output; broadcast {lead['tick_bytes']}"
        f" bytes a tick in {lead['tick_bcast_ms']:.3f} ms (median), the "
        f"lead's tick {lead['tick_ms']:.3f} ms. MultihostResidentScheduler, "
        f"rank, {MH_TICKS} ticks: {lead['packets']} packets of "
        f"{lead['packet_bytes']} bytes, broadcast in "
        f"{lead['packet_bcast_ms']:.3f} ms (median; a follower's wait "
        f"includes the lead's host work: "
        f"{follower['packet_bcast_ms']:.3f} ms), B1 launched "
        f"{lead['b1_launches']} times in each process, both replicas and "
        f"the single process's state bit for bit, every resolved tick equal "
        f"[{card}]")
    log(f"phase mesh (c): MultihostTick, Sinkhorn, {MH_SK_TICKS} ticks, one "
        f"position a process (the scripted tick's collectives through "
        f"gloo): both ranks bit for bit; the lead's ticks "
        f"{[round(t, 3) for t in lead['sinkhorn_tick_ms']]} ms (host clock); "
        f"against the single-device tick: {'; '.join(lead['sinkhorn_detail'])}"
        f" [{card}]")
    return dict(lead=lead, follower=follower)


#: (d)'s layouts through the entry point: flags, requests, processes
MH_LAYOUTS = ((("--resident", "--multihost"), MH_REQUESTS, 2),
              (("--multihost",), MH_BURST, 2),
              (("--mesh", "1"), MH_BURST, 1),
              (("--mesh", "1", "--resident"), MH_BURST, 1))


def mesh_start(dev, flags: tuple, n_procs: int) -> dict:
    """Start one layout of ``python -m tpu_faas_torch.dispatch -m
    tpu-push`` with the port's store server in this process: a lead and a
    follower on the one card (gloo) when ``n_procs`` is 2, else one
    process; the lead serves its stats on a port of its own."""
    from tpu_faas_torch.store.launch import start_store_thread

    root = os.path.dirname(os.path.abspath(__file__))
    handle = start_store_thread()
    coord, zmq_port, stats = free_port(), free_port(), free_port()
    common = ["-m", "tpu_faas_torch.dispatch", "-m", "tpu-push", *flags,
              "--device", dev.type, "-i", "127.0.0.1", "-p", str(zmq_port),
              "--store", handle.url, "--max-fleet", "64", "--tte", "5"]
    if n_procs == 2:
        common += ["--dist-backend", "gloo", "--coordinator",
                   f"127.0.0.1:{coord}", "--num-processes", "2",
                   "--follower-watchdog", str(MH_TIMEOUT_S)]
        procs = [spawn(common + ["--process-id", "0", "--stats-port",
                                 str(stats)], root),
                 spawn(common + ["--process-id", "1"], root)]
    else:
        procs = [spawn(common + ["--stats-port", str(stats)], root)]
    return dict(flags=flags, handle=handle, procs=procs, stats=stats,
                url=f"tcp://127.0.0.1:{zmq_port}",
                t_start=time.perf_counter())


def mesh_serve(layout: dict, n_requests: int) -> dict:
    """Serve ``n_requests`` requests of ``smoke_fn`` through a started
    layout's lead and MH_WORKERS wire workers, in bursts of MH_BURST; each
    answered once; then SIGTERM to the lead, which releases the follower,
    and every process exits 0."""
    import signal
    import urllib.request

    from tpu_faas_torch.core.executor import pack_params
    from tpu_faas_torch.core.serialize import deserialize, serialize
    from tpu_faas_torch.core.task import FIELD_RESULT, FIELD_STATUS, new_task_id
    from tpu_faas_torch.store.base import RESULTS_CHANNEL
    from tpu_faas_torch.store.launch import make_store
    from tpu_faas_torch.utils.config import Config

    procs, flags = layout["procs"], layout["flags"]
    store = make_store(layout["handle"].url)
    results = store.subscribe(RESULTS_CHANNEL)
    workers = []
    try:
        deadline = time.monotonic() + MH_TIMEOUT_S
        workers = [WireWorker(layout["url"], f"mesh-w{i}")
                   for i in range(MH_WORKERS)]
        while True:
            assert time.monotonic() < deadline, "the lead never served"
            assert all(p.poll() is None for p in procs), "a process exited"
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{layout['stats']}/stats",
                        timeout=2) as f:
                    if json.loads(f.read())["workers_registered"] \
                            >= MH_WORKERS:
                        break
            except OSError:
                pass
            time.sleep(0.2)
        t_ready = time.perf_counter()
        fn = serialize(smoke_fn)
        channel = Config.load().tasks_channel
        value, seen = {}, {}
        for lo in range(0, n_requests, MH_BURST):
            batch = [(new_task_id(), i) for i in range(
                lo, min(lo + MH_BURST, n_requests))]
            store.create_tasks([(t, fn, pack_params(i)) for t, i in batch],
                               channel)
            value.update(batch)
            time.sleep(0.03)
        while len(seen) < n_requests:
            assert time.monotonic() < deadline, (
                f"{n_requests - len(seen)} requests unanswered")
            tid = results.get_message(timeout=0.05)
            if tid is not None:
                seen[tid] = seen.get(tid, 0) + 1
        t_done = time.perf_counter()
        time.sleep(0.5)  # a duplicate announce would land by now
        while (tid := results.get_message(timeout=0.05)) is not None:
            seen[tid] = seen.get(tid, 0) + 1
        assert set(seen) == set(value) and set(seen.values()) == {1}, seen
        recs = store.hgetall_many(list(value))
        assert all(r.get(FIELD_STATUS) == "COMPLETED"
                   and deserialize(r[FIELD_RESULT]) == smoke_fn(value[t])
                   for t, r in zip(value, recs)), "a wrong result"
        os.killpg(procs[0].pid, signal.SIGTERM)
        outs = finish(procs, timeout=60)
    finally:
        for w in workers:
            w.stop()
        results.close()
        store.close()
    if len(procs) == 2:
        stop = ("multihost resident stop broadcast sent"
                if "--resident" in flags else "multihost stop broadcast sent")
        assert stop in outs[0], outs[0][-2000:]
        assert "stop after" in outs[1], outs[1][-2000:]
        assert all("backend gloo" in o for o in outs)
    return dict(requests=n_requests, serve_s=t_done - t_ready,
                start_s=t_ready - layout["t_start"])


def mesh_entry_point(dev, card: str) -> dict:
    """(d) every layout of MH_LAYOUTS through the entry point, all started
    at once and then served in turn; and, on a machine with fewer than 4
    cards, ``--mesh 4`` exits at startup with the device-count message."""
    root = os.path.dirname(os.path.abspath(__file__))
    n_cards = torch.cuda.device_count()
    layouts, out = [], {}
    too_many = None
    try:
        if n_cards < 4:
            too_many = spawn(["-m", "tpu_faas_torch.dispatch", "-m",
                              "tpu-push", "--mesh", "4", "--store",
                              "memory://", "-p", "0"], root)
        for flags, _, n_procs in MH_LAYOUTS:
            layouts.append(mesh_start(dev, flags, n_procs))
        for layout, (flags, n, n_procs) in zip(layouts, MH_LAYOUTS):
            r = out[" ".join(flags)] = mesh_serve(layout, n)
            who = ("a lead and a follower on the one card, gloo"
                   if n_procs == 2 else "one process")
            log(f"phase mesh (d): python -m tpu_faas_torch.dispatch -m "
                f"tpu-push {' '.join(flags)}, {who}: {n} of {n} requests "
                f"answered once with their values through {MH_WORKERS} wire "
                f"workers, written in bursts of {MH_BURST}; "
                + ("the lead's SIGTERM released the follower and both "
                   "exited 0" if n_procs == 2
                   else "it exited 0 on SIGTERM")
                + f"; serving {r['serve_s']:.3f} s, ready "
                f"{r['start_s']:.3f} s after its start (the layouts start "
                f"together) [{card}]")
        if too_many is not None:
            o = finish_failing(too_many)
            want = (f"mesh_devices=4 but only {n_cards} CUDA devices are "
                    "available")
            assert want in o, o[-2000:]
            log(f"  --mesh 4 with {n_cards} card(s): exited "
                f"{too_many.returncode} at startup with '{want}'")
    finally:
        for p in [too_many] + [p for lay in layouts for p in lay["procs"]]:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        for lay in layouts:
            lay["handle"].stop()
    return out


def finish_failing(p) -> str:
    """The output of a child that must exit non-zero; killed if it does
    not exit."""
    try:
        o, _ = p.communicate(timeout=MH_TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode != 0, o[-2000:]
    return o


def phase_mesh(dev, card: str) -> dict:
    """(a)-(d); the B1 and B2 launches on the mesh paths, each counted from
    0 just before its path."""
    t0 = time.perf_counter()
    a = mesh_one_card(dev, card)
    assert all(n > 0 for n in a["b2"]), a["b2"]
    a["rank_batch"] = scripted_rank_tick(dev, card)
    bb = mesh_batch_churn(dev)
    br = mesh_resident_churn(dev)
    log(f"phase mesh (b): mesh_devices=1 on cuda, {bb['ticks']} headline "
        f"ticks each: SchedulerArrays equal to the loop without a mesh on "
        f"every output ({bb['placed']} placed, {bb['purged']} rows purged); "
        f"ResidentScheduler equal on every resolved tick and the final state "
        f"({br['placed']} placed), B1 launched {br['launches']} times "
        f"(a tick: {br['per_tick']}), one a steady tick. At N=1 the "
        f"resident leg checks the construction only: no padding, the same "
        f"code as without a mesh; (c) runs the padded shape")
    c = mesh_two_processes(dev, card)
    d = mesh_entry_point(dev, card)
    log(f"phase mesh: {time.perf_counter() - t0:.1f} s")
    return dict(a=a, b2_launches=a["b2"], b1_launches=[
        br["launches"], c["lead"]["b1_launches"],
        c["follower"]["b1_launches"]], c=c, d=d)


def main() -> int:
    if len(sys.argv) > 1:
        print(f"usage: python3 {sys.argv[0]}  (no arguments: every phase "
              f"runs)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from tpu_faas_torch.sched import bid, fused_tick

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {kind}")
    t0 = time.perf_counter()
    # the probe build: the fused tick with the auction's phase stamps
    probe = fused_tick.FusedTickKernel(probe=True)
    kernels = (fused_tick.KERNEL, probe, bid.KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per build
        for f in [pool.submit(k.load) for k in kernels]:
            f.result()
    log(f"phase build: fused_tick, its probe build and bid_top2 built in "
        f"{time.perf_counter() - t0:.1f} s")
    for k in kernels:
        name = k.name + (" (probe)" if k is probe else "")
        for line in k.ptxas_report.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Function properties")):
                log(f"  ptxas {name}: {line.strip()}")

    log_bid_loops()
    phase_analysis(card)

    rk = phase_kernel(dev)
    re = rank_edges(dev)
    fused_tick.KERNEL.launches = 0  # count the main path alone
    fell = fused_tick.KERNEL.rank_fallbacks(dev, SHAPE["T"], SHAPE["W"],
                                            MAX_SLOTS)
    rr = phase_resident(dev, N_TICKS, N_TIMED)
    launches = fused_tick.KERNEL.launches
    assert launches > 0, "the main path never launched"
    fell = fused_tick.KERNEL.rank_fallbacks(dev, SHAPE["T"], SHAPE["W"],
                                            MAX_SLOTS) - fell
    log(f"  rank ticks of the loop that took the full-length path: {fell} "
        f"of {launches} launches")
    log(f"  integrated tick_resident (diff, pack, upload, kernel; "
        f"synchronized): {statistics.median(rr['tick_ms']):.4f} ms, host "
        f"enqueue alone {statistics.median(rr['tick_enqueue_ms']):.4f} ms, "
        f"packet upload + kernel on the card "
        f"{statistics.median(rr['launch_ms']):.4f} ms, medians of "
        f"{len(rr['tick_ms'])} ticks [{card}]")
    phase_sim(dev)
    rb = phase_bid(dev)
    bid.KERNEL.launches = 0  # count the auction path alone
    ra = phase_auction(dev)
    bid_launches = bid.KERNEL.launches
    assert bid_launches > 0, "the auction path never launched bid_top2"
    log(f"  B2 launches on the auction path: {bid_launches} in "
        f"{ra['ticks']} ticks, rounds per tick {ra['rounds']}")
    rka = phase_auction_kernel(dev, probe)
    fused_tick.KERNEL.launches = 0  # count the resident auction loop alone
    fused_tick.KERNEL.auction_launches = 0
    rra = phase_resident(dev, N_AUCTION_TICKS, N_AUCTION_TIMED,
                         placement="auction")
    auction_launches = fused_tick.KERNEL.auction_launches
    assert auction_launches > 0, "the resident auction never launched"
    log(f"  integrated tick_resident, auction (diff, pack, upload, kernel; "
        f"synchronized): {statistics.median(rra['tick_ms']):.4f} ms, host "
        f"enqueue alone {statistics.median(rra['tick_enqueue_ms']):.4f} ms, "
        f"packet upload + kernel on the card "
        f"{statistics.median(rra['launch_ms']):.4f} ms, medians of "
        f"{len(rra['tick_ms'])} ticks; auction launches {auction_launches} "
        f"[{card}]")
    log(f"  round split of the loop's states (probe build) [{card}]:")
    rsa = resident_auction_split(dev, probe, rra["samples"])
    rks = phase_sinkhorn_kernel(dev, probe)
    fused_tick.KERNEL.launches = 0  # count the resident Sinkhorn loop alone
    fused_tick.KERNEL.sinkhorn_launches = 0
    rrs = phase_resident(dev, N_SINKHORN_TICKS, N_SINKHORN_TIMED,
                         placement="sinkhorn")
    sinkhorn_launches = fused_tick.KERNEL.sinkhorn_launches
    assert sinkhorn_launches > 0, "the resident Sinkhorn never launched"
    log(f"  integrated tick_resident, Sinkhorn (diff, pack, upload, kernel; "
        f"synchronized): {statistics.median(rrs['tick_ms']):.4f} ms, host "
        f"enqueue alone {statistics.median(rrs['tick_enqueue_ms']):.4f} ms, "
        f"packet upload + kernel on the card "
        f"{statistics.median(rrs['launch_ms']):.4f} ms, medians of "
        f"{len(rrs['tick_ms'])} ticks; Sinkhorn launches "
        f"{sinkhorn_launches} [{card}]")
    phase_sinkhorn_batch(dev)
    rt = phase_resident_tenancy(dev, card, probe)
    t0 = time.perf_counter()
    rsp = phase_resident_spec(dev, card, probe)
    log(f"phase resident_spec: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_graph(dev, card)
    log(f"phase graph: {time.perf_counter() - t0:.1f} s")
    log(f"phase time [{card}]:")
    t = phase_time(dev, N_TIMED, rr["samples"], probe)
    tb = time_bid(dev, N_TIMED // 3)
    time_auction(ra, 3)
    ta = time_resident_auction(
        dev, rra["samples"], [sp["counts"]["n_match"] for sp in rsa["splits"]])
    ts = time_resident_sinkhorn(dev, rrs["samples"], probe)
    rd = phase_dispatcher(dev, card)
    rst = phase_stack(card)
    rpl = phase_planes(card)
    t0 = time.perf_counter()
    phase_profile(dev, card)
    graph_card_ms(dev, card)
    log(f"phase profile: {time.perf_counter() - t0:.1f} s")
    # after the dispatcher phase: the walk then finds no JAX module loaded
    # with the dispatcher's imports in place
    rm = phase_mesh(dev, card)
    rbe = phase_bench(dev, card)
    phase_host()
    entry = {"name": "fused_resident_tick", "route": "cuda",
             "source": fused_tick.SOURCE, "replaces": fused_tick.REPLACES,
             "launches": launches,
             "mismatches": (rk["mismatches"] + re["mismatches"]
                            + rr["mismatches"] + rt["mismatches"]["rank"]
                            + rd["host"]["mismatches"]
                            + rbe["b1"]["mismatches"]),
             "max_abs_err": max(rk["max_abs_err"], re["max_abs_err"],
                                rr["max_abs_err"],
                                rt["max_abs_err"]["rank"],
                                rd["host"]["max_abs_err"],
                                rbe["b1"]["max_abs_err"]),
             "ms": t["loop"][0], "plain_ms": t[True][1],
             "bound_ms": t["loop"][1], "bound_by": "bytes",
             "library_ms": None,
             # the dispatcher phase's paths, each counted from 0: the serve
             # leg and the host-dispatch leg's timed pass
             "dispatcher_launches": [rd["serve"]["launches"],
                                     rd["host"]["launches"]],
             # the mesh phase's paths, each counted from 0: (b)'s resident
             # loop under mesh_devices=1, and (c)'s lead and follower
             "mesh_launches": rm["b1_launches"],
             # the stack phase's tpu-push --resident leg: the dispatcher
             # process's launches and resident ticks, from its /metrics
             "stack_launches": rst["launches"], "stack_ticks": rst["ticks"],
             # the planes phase's dispatcher processes, from their /metrics
             "planes_launches": rpl["launches"], "planes_ticks": rpl["ticks"],
             # the bench phase: config 15's process (its ladder and dry
             # runs, from the CLI's line), and the larger shapes' checks
             "bench_launches": [rbe["b1_launches"], rbe["b1"]["launches"]]}
    k_ms, p_ms, b_ms, by = tb["headline"]
    # no single PyTorch call computes the hashed top-2 bid
    entry_b2 = {"name": "bid_top2", "route": "cuda", "source": bid.SOURCE,
                "replaces": bid.REPLACES, "launches": bid_launches,
                "mismatches": rb["mismatches"] + ra["mismatches"],
                "max_abs_err": rb["max_abs_err"], "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                "library_ms": None,
                # the mesh phase's (a), counted from 0: the gspmd auction
                # (one launch a round) and the permute one (one a run of
                # positions on one device a round)
                "mesh_launches": rm["b2_launches"],
                # the bench phase's config 7 process (its line's count)
                "bench_launches": rbe["b2_launches"]}
    # no single PyTorch call computes a resident auction tick
    entry_b1a = {"name": "fused_resident_tick_auction", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.AUCTION_REPLACES,
                 "launches": auction_launches,
                 "mismatches": (rka["mismatches"] + rra["mismatches"]
                                + rsa["mismatches"] + ta["mismatches"]
                                + rt["mismatches"]["auction"]),
                 "max_abs_err": max(rka["max_abs_err"], rra["max_abs_err"],
                                    ta["max_abs_err"],
                                    rt["max_abs_err"]["auction"]),
                 "ms": ta["ms"], "plain_ms": ta["plain_ms"],
                 "bound_ms": ta["bound_ms"], "bound_by": ta["bound_by"],
                 "library_ms": None}
    # no single PyTorch call computes a resident Sinkhorn tick
    entry_b1s = {"name": "fused_resident_tick_sinkhorn", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.SINKHORN_REPLACES,
                 "launches": sinkhorn_launches,
                 "mismatches": (rks["mismatches"] + rrs["mismatches"]
                                + rt["mismatches"]["sinkhorn"]),
                 "max_abs_err": max(rks["dg"], rrs["max_abs_err"],
                                    rt["max_abs_err"]["sinkhorn"]),
                 "ms": ts["ms"], "plain_ms": ts["plain_ms"],
                 "bound_ms": ts["bound_ms"], "bound_by": ts["bound_by"],
                 "library_ms": None}
    # the rank branch with the tenancy lane on; no single PyTorch call
    # computes a resident tick with fair admission
    entry_b1t = {"name": "fused_resident_tick_tenancy", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.TENANCY_REPLACES,
                 "launches": rt["launches"],
                 "mismatches": rt["mismatches"]["rank"],
                 "max_abs_err": rt["max_abs_err"]["rank"], "ms": rt["ms"],
                 "plain_ms": rt["plain_ms"], "bound_ms": rt["bound_ms"],
                 "bound_by": "bytes", "library_ms": None}
    # the rank branch with the speculation lane on; no single PyTorch call
    # computes a resident tick with straggler flags and the hedge fixup
    entry_b1g = {"name": "fused_resident_tick_spec", "route": "cuda",
                 "source": fused_tick.SOURCE,
                 "replaces": fused_tick.SPEC_REPLACES,
                 "launches": rsp["launches"],
                 "mismatches": rsp["mismatches"]["rank"],
                 "max_abs_err": rsp["max_abs_err"]["rank"], "ms": rsp["ms"],
                 "plain_ms": rsp["plain_ms"], "bound_ms": rsp["bound_ms"],
                 "bound_by": "bytes", "library_ms": None}
    log(f"card: {card}")
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry, entry_b2, entry_b1a, entry_b1s,
                                  entry_b1t, entry_b1g]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
