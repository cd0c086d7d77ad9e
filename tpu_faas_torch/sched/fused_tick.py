"""The resident tick as ONE hand-written CUDA launch, and its wrapper.

Counterpart of ``tpu_faas/sched/pallas_fused.py``: the TPU kernel
``_fused_resident_tick_impl`` runs the whole resident tick as one
``pl.pallas_call``; here ``csrc/fused_tick.cu`` does the same for Hopper —
apply the delta packet, liveness, purge, redispatch, placement and output
compaction in one launch, with the state tensors updated in place (the
counterpart of the Pallas kernel's ``input_output_aliases``: their
``data_ptr()`` never changes across ticks). Rank placement is one
cooperative launch over the card that sorts only the valid slots and the
admitted tasks (the flush mode is one thread block); the auction is one
cooperative launch too, its bidding rounds looping on the device, and also
updates the carried ``price`` and ``refresh`` leaves in place.

:func:`fused_resident_tick` is the entry. On CPU tensors it runs the plain
PyTorch version, ``resident._resident_tick_impl`` (the CPU has no kernel);
on CUDA tensors it launches the kernel or raises — there is no fallback.
The kernel launches on the current stream, does not synchronise and
allocates nothing: the wrapper allocates scratch once per shape and the
outputs fresh every tick, so a tick issued before the previous one is read
back never overwrites that one's outputs. An auction tick's round count,
spilled count and bidder rows (summed over its rounds) come back as device
tensors, which the wrapper never reads; ``ResidentScheduler.resolve_next``
reads the first two while a ``torch.profiler`` capture runs, as counters
of ``obs/profile.py``'s span log. Sinkhorn placement is a third
cooperative launch: its iterations alternate row and column logsumexps
across the grid, and its final potentials also come back as device tensors
the wrapper never reads. With the tenancy plane on (``use_tenancy``, ``NT``
tenant rows, as many as the int32 segment key holds: ``check_segment_key``)
each entry and the flush also take the ``tenant`` and ``t_deficit`` leaves,
update them in place, and return the tick's eligibility mask as a fresh
output. With the speculation plane on (``use_spec``) each entry and the
flush also take the ``infl_start``, ``infl_pred`` and ``avoid`` leaves and
update them in place, and the tick reports its first ``KG`` straggler
slots.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_faas_torch.build import build, check_arg
from tpu_faas_torch.sched.auction import EPS, WARM_ROUNDS, bid_scalars
from tpu_faas_torch.sched.resident import (
    _HEADER,
    ResidentTickOutput,
    _flush_kernel_impl,
    _resident_tick_impl,
    _ResidentState,
)
from tpu_faas_torch.sched.sinkhorn import TAU
from tpu_faas_torch.sched.state import (
    BUCKETED_ITERS,
    DENSE_ITERS,
    N_BUCKETS,
    check_placement,
    sinkhorn_bucketed,
)
from tpu_faas_torch.tenancy.fairshare import (
    DEFAULT_DEFICIT_CAP,
    DEFAULT_STARVE_BOOST,
    DEFAULT_STARVE_DEFICIT,
    check_segment_key,
)

SOURCE = "tpu_faas_torch/csrc/fused_tick.cu"
REPLACES = "tpu_faas/sched/pallas_fused.py:147 (_fused_resident_tick_impl)"
#: the auction branch of the same TPU kernel: the resident carry of
#: auction_placement_impl, traced inside it by _resident_tick_impl
AUCTION_REPLACES = ("tpu_faas/sched/pallas_fused.py:147 "
                    "(_fused_resident_tick_impl, placement=\"auction\")")
#: the Sinkhorn branch: scheduler_tick_impl's Sinkhorn solvers, traced
#: inside the same TPU kernel
SINKHORN_REPLACES = ("tpu_faas/sched/pallas_fused.py:147 "
                     "(_fused_resident_tick_impl, placement=\"sinkhorn\")")
#: the tenancy lane of the same TPU kernel (use_tenancy, NT), traced inside
#: it through scheduler_tick_impl's tenancy plane
TENANCY_REPLACES = ("tpu_faas/sched/pallas_fused.py:147 "
                    "(_fused_resident_tick_impl, use_tenancy=True)")
#: the speculation lane of the same TPU kernel (use_spec, KG), traced inside
#: it through scheduler_tick_impl's straggler flags and hedge fixup
SPEC_REPLACES = ("tpu_faas/sched/pallas_fused.py:147 "
                 "(_fused_resident_tick_impl, use_spec=True)")
_P = ctypes.c_void_p
_N_PTR = 13  # packet, 9 state leaves, out_i32, out_b8, scratch
_N_INT = 15  # T W I KA KH KF KI KS KB KP KR KG max_slots prio flush
_N_PTR_AUCTION = 15  # packet, 9 state leaves, price, refresh, outs, scratch
_N_INT_AUCTION = 15  # T W I KA KH KF KI KS KB KP KR KG max_slots prio
#                      warm_rounds
_N_PTR_SINKHORN = 16  # packet, 9 state leaves, outs, f, g, tau, scratch
_N_INT_SINKHORN = 17  # T W I KA KH KF KI KS KB KP KR KG max_slots prio
#                       bucketed n_buckets n_iters
#: every entry's tenancy arguments, before the stream: the tenant and
#: t_deficit leaves, the eligibility output, the adm_rank scratch;
#: use_tenancy, NT, starve_deficit, starve_boost, deficit_cap
_TENANCY_TYPES = [_P] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                  ctypes.c_int,
                                                  ctypes.c_float]
#: then the speculation arguments: the infl_start, infl_pred and avoid
#: leaves, the fixup's free-count scratch [W]; use_spec
_SPEC_TYPES = [_P] * 4 + [ctypes.c_int]
#: the cooperative entries' own error codes
#: the Sinkhorn stamps' layout (``csrc/fused_tick.cu``: kStamps phase
#: stamps, then the probe build's kSkIters x 4 iteration words from
#: kSkIter, 6 close words from kSkClose, 4 counts from kSkCount and the 4
#: lanes' clocks from kSkLanes)
SK_PHASES, SK_ITERS = 8, 64
SK_ITER = SK_PHASES
SK_CLOSE = SK_ITER + 4 * SK_ITERS
SK_COUNT = SK_CLOSE + 6
SK_LANES = SK_COUNT + 4
SK_STAMPS = SK_LANES + 4
#: the auction stamps' layout (kStampRound, kStampRounds, kStampClose,
#: kStampLanes, kAuStamps): 4 open the launch, 5 follow each stamped
#: round, 2 close it, then the 4 lanes' clocks
AU_ROUND, AU_ROUNDS = 4, 64
AU_CLOSE = AU_ROUND + 5 * AU_ROUNDS
AU_LANES = AU_CLOSE + 2
AU_STAMPS = AU_LANES + 4
#: the rank branch's stamps (``csrc/fused_tick.cu``: kRkStamps words at the
#: end of its scratch): 0 start, then block 0's clock at the end of each of
#: RANK_PHASES, then the counts RANK_COUNTS
RANK_STAMPS = 16
RANK_PHASES = ("packet", "liveness", "lists", "tenancy", "select",
               "admission", "sorts", "pairing", "fixup", "deficit",
               "compaction")
RANK_COUNTS = ("n_slots", "n_admitted", "passes", "fallback")
_COOP_ERRORS = {
    -1: "the device has no cooperative launch",
    -2: "no block of the kernel fits on an SM",
}


def lane_split(start: int, opened: int, closed: int, end: int,
               lanes: list[int]) -> dict:
    """The lanes' parts of an auction or Sinkhorn launch's opening and
    end, in ms, from block 0's clocks: the launch's start, the opening's
    end, the placement's close and the launch's end, and the lanes' four
    words (after the packet, after liveness, after the fixup, after the
    deficit carry; the last two 0 with the lanes off)."""
    packet, live, fixup, deficit = lanes
    if not fixup:  # the lanes off: the end is the compaction alone
        fixup = deficit = closed

    def ms(a, b):
        return (b - a) / 1e6

    return {"packet": ms(start, packet), "liveness": ms(packet, live),
            "tenancy": ms(live, opened), "fixup": ms(closed, fixup),
            "deficit": ms(fixup, deficit), "compaction": ms(deficit, end)}


class FusedTickKernel:
    """The built library, its per-shape scratch and its launch counts: one
    for the rank tick and the flush, one for the auction branch, one for
    the Sinkhorn branch. ``probe=True`` builds the library with
    ``-DTPU_FAAS_PROBE``: its rank launches also stamp block 0's clock at
    each phase (:meth:`rank_split`), its auction launches at each phase and
    round (:meth:`auction_split`), and its Sinkhorn launches at each
    iteration's updates and barriers and in the close
    (:meth:`sinkhorn_split`)."""

    name = "fused_tick"

    def __init__(self, probe: bool = False) -> None:
        self.probe = probe
        #: rank-tick and flush launches so far; callers may reset it to 0
        self.launches = 0
        #: auction-branch launches so far; callers may reset it to 0
        self.auction_launches = 0
        #: Sinkhorn-branch launches so far; callers may reset it to 0
        self.sinkhorn_launches = 0
        #: launches of any branch (or flush) with the tenancy lane on, so
        #: far; callers may reset it to 0
        self.tenancy_launches = 0
        #: launches of any branch (or flush) with the speculation lane on,
        #: so far; callers may reset it to 0
        self.spec_launches = 0
        self.ptxas_report = ""
        self._fn = None
        self._fn_auction = None
        self._fn_sinkhorn = None
        self._sinkhorn_words = None
        self._fn_math = self._stamps_at = self._fn_barrier = None
        self._auction_words = self._auction_stamps_at = None
        self._rank_words = self._rank_stamps_at = None
        self._rank_fallbacks_at = self._tenancy_words = None
        self._scratch: dict[tuple, torch.Tensor] = {}

    def load(self) -> None:
        """Build (if needed) and load the library; idempotent."""
        if self._fn is not None:
            return
        path, report = build(self.name,
                             ("TPU_FAAS_PROBE",) if self.probe else ())
        self.ptxas_report = report
        lib = ctypes.CDLL(str(path))
        fn = lib.tpu_faas_fused_resident_tick
        fn.argtypes = ([_P] * _N_PTR + [ctypes.c_int] * _N_INT
                       + _TENANCY_TYPES + _SPEC_TYPES + [_P])  # stream
        fn.restype = ctypes.c_int
        auction = lib.tpu_faas_fused_resident_auction
        auction.argtypes = ([_P] * _N_PTR_AUCTION
                            + [ctypes.c_int] * _N_INT_AUCTION
                            + [ctypes.c_float] * 2  # eps jitter
                            + _TENANCY_TYPES + _SPEC_TYPES + [_P])  # stream
        auction.restype = ctypes.c_int
        sinkhorn = lib.tpu_faas_fused_resident_sinkhorn
        sinkhorn.argtypes = ([_P] * _N_PTR_SINKHORN
                             + [ctypes.c_int] * _N_INT_SINKHORN
                             + [ctypes.c_float]  # tau
                             + _TENANCY_TYPES + _SPEC_TYPES
                             + [_P])  # stream
        sinkhorn.restype = ctypes.c_int
        words = lib.tpu_faas_fused_sinkhorn_scratch_words
        words.argtypes = [ctypes.c_int] * 5
        words.restype = ctypes.c_longlong
        self._fn_sinkhorn, self._sinkhorn_words = sinkhorn, words
        probe = lib.tpu_faas_math_probe
        probe.argtypes = [_P] * 3 + [ctypes.c_int, _P]
        probe.restype = ctypes.c_int
        stamps = lib.tpu_faas_fused_sinkhorn_stamps_offset
        stamps.argtypes = [ctypes.c_int] * 5
        stamps.restype = ctypes.c_longlong
        barrier = lib.tpu_faas_barrier_probe
        barrier.argtypes = [ctypes.c_int, _P]
        barrier.restype = ctypes.c_int
        self._fn_math, self._stamps_at, self._fn_barrier = (probe, stamps,
                                                            barrier)
        awords = lib.tpu_faas_fused_auction_scratch_words
        astamps = lib.tpu_faas_fused_auction_stamps_offset
        for f in (awords, astamps):
            f.argtypes = [ctypes.c_int] * 3
            f.restype = ctypes.c_longlong
        self._auction_words, self._auction_stamps_at = awords, astamps
        n_au = lib.tpu_faas_fused_auction_stamp_count()
        if n_au != AU_STAMPS:
            raise RuntimeError(f"the library keeps {n_au} auction stamps, "
                               f"the wrapper reads {AU_STAMPS}")
        rwords = lib.tpu_faas_fused_rank_scratch_words
        rstamps = lib.tpu_faas_fused_rank_stamps_offset
        rfall = lib.tpu_faas_fused_rank_fallbacks_offset
        for f in (rwords, rstamps, rfall):
            f.argtypes = [ctypes.c_int] * 3
            f.restype = ctypes.c_longlong
        self._rank_words, self._rank_stamps_at = rwords, rstamps
        self._rank_fallbacks_at = rfall
        n_rk = lib.tpu_faas_fused_rank_stamp_count()
        if n_rk != RANK_STAMPS:
            raise RuntimeError(f"the library keeps {n_rk} rank stamps, the "
                               f"wrapper reads {RANK_STAMPS}")
        twords = lib.tpu_faas_fused_tenancy_scratch_words
        twords.argtypes = [ctypes.c_int]
        twords.restype = ctypes.c_longlong
        self._tenancy_words = twords
        n_sk = lib.tpu_faas_fused_sinkhorn_stamp_count()
        if n_sk != SK_STAMPS:
            raise RuntimeError(f"the library keeps {n_sk} Sinkhorn stamps, "
                               f"the wrapper reads {SK_STAMPS}")
        self._fn, self._fn_auction = fn, auction

    def _scratch_for(self, dev: torch.device, key: tuple,
                     words: int) -> torch.Tensor:
        # one buffer per (device, shape, branch); launches on one stream
        # run in order, so reusing it across ticks is safe. Zeroed once:
        # the rank branch keeps a count across launches in it
        buf = self._scratch.get((dev, *key))
        if buf is None:
            buf = torch.zeros(words, dtype=torch.int32, device=dev)
            self._scratch[(dev, *key)] = buf
        return buf

    def _check(self, packet, st, T, W, I, KA, KH, KF, KI, KS, KB,
               use_priority, use_tenancy, NT, use_spec, KG, auction_S=None):
        dev = packet.device
        if use_tenancy:
            if NT < 1:
                raise ValueError(f"the tenancy lane takes at least 1 tenant "
                                 f"row, got NT={NT}")
            check_segment_key(NT, T)
        lanes = (1 + int(bool(use_priority)) + int(bool(use_tenancy))
                 + int(bool(use_spec)))
        P = (_HEADER + KA * lanes + 2 * (KH + KF + KI + KS + KB)
             + (KI + 2 if use_spec else 0)
             + (3 * NT if use_tenancy else 0))
        check_arg(packet, "packet", torch.float32, P, dev)
        leaves = [
            ("sizes", torch.float32, T), ("valid", torch.bool, T),
            ("prio", torch.int32, T), ("last_hb", torch.float32, W),
            ("free", torch.int32, W), ("inflight", torch.int32, I),
            ("prev_live", torch.bool, W), ("speed", torch.float32, W),
            ("active", torch.bool, W),
        ]
        if auction_S is not None:
            leaves.append(("price", torch.float32, auction_S))
        if use_tenancy:
            leaves += [("tenant", torch.int32, T),
                       ("t_deficit", torch.float32, NT)]
        if KG < 1:
            raise ValueError(f"the straggler output takes KG >= 1, got {KG}")
        if use_spec:
            leaves += [("infl_start", torch.float32, I),
                       ("infl_pred", torch.float32, I),
                       ("avoid", torch.int32, T)]
        for name, dtype, n in leaves:
            check_arg(getattr(st, name), name, dtype, n, dev)
        if auction_S is not None:
            # the staleness flag is a bool scalar (one element)
            check_arg(st.refresh.reshape(-1), "refresh", torch.bool, 1, dev)
        return dev

    def _tenancy(self, st, dev, T, use_tenancy, NT):
        """(eligibility output or None, the entries' tenancy arguments)."""
        if not use_tenancy:
            return None, (None, None, None, None, 0, 1,
                          DEFAULT_STARVE_DEFICIT, DEFAULT_STARVE_BOOST,
                          DEFAULT_DEFICIT_CAP)
        elig = torch.empty(T, dtype=torch.bool, device=dev)
        # per tenant a count word and a demand byte, then the rank grid's
        # per-tile counts and first positions
        scratch = self._scratch_for(dev, ("tenancy", NT),
                                    self._tenancy_words(NT))
        return elig, (st.tenant.data_ptr(), st.t_deficit.data_ptr(),
                      elig.data_ptr(), scratch.data_ptr(), 1, NT,
                      DEFAULT_STARVE_DEFICIT, DEFAULT_STARVE_BOOST,
                      DEFAULT_DEFICIT_CAP)

    def _spec(self, st, dev, W, use_spec):
        """The entries' speculation arguments."""
        if not use_spec:
            return (None, None, None, None, 0)
        free_rem = self._scratch_for(dev, ("spec", W), W)
        return (st.infl_start.data_ptr(), st.infl_pred.data_ptr(),
                st.avoid.data_ptr(), free_rem.data_ptr(), 1)

    def _count(self, use_tenancy, use_spec):
        self.tenancy_launches += int(bool(use_tenancy))
        self.spec_launches += int(bool(use_spec))

    @staticmethod
    def _outputs(out_i32, out_b8, W, KA, KP, KR, KG, aux=False, elig=None):
        o = 2 * KP + KA + KR
        return ResidentTickOutput(
            placed_slots=out_i32[:KP],
            placed_rows=out_i32[KP : 2 * KP],
            arrival_slots=out_i32[2 * KP : 2 * KP + KA],
            redispatch_slots=out_i32[2 * KP + KA : o],
            purged=out_b8[:W],
            live=out_b8[W:],
            n_pending=out_i32[o],
            straggler_slots=out_i32[o + 1 : o + 1 + KG],
            auction_rounds=out_i32[o + 1 + KG] if aux else None,
            auction_spilled=out_i32[o + 2 + KG] if aux else None,
            auction_bid_rows=out_i32[o + 3 + KG] if aux else None,
            tenant_eligible=elig,
        )

    def __call__(self, packet, st, *, T, W, I, KA, KH, KF, KI, KS, KB, KP,
                 KR, max_slots, use_priority, flush, use_tenancy=False,
                 NT=1, use_spec=False, KG=1):
        """A rank tick (one cooperative launch), or (``flush=True``) the
        delta packet alone (one block)."""
        dev = self._check(packet, st, T, W, I, KA, KH, KF, KI, KS, KB,
                          use_priority, use_tenancy, NT, use_spec, KG)
        self.load()
        elig, ten = self._tenancy(st, dev, T, use_tenancy, NT)
        spec = self._spec(st, dev, W, use_spec)
        out_i32 = torch.empty(2 * KP + KA + KR + 1 + KG, dtype=torch.int32,
                              device=dev)
        out_b8 = torch.empty(2 * W, dtype=torch.bool, device=dev)
        scratch = self._scratch_for(dev, ("rank", T, W, max_slots),
                                    self._rank_words(T, W, max_slots))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(
                packet.data_ptr(), st.sizes.data_ptr(), st.valid.data_ptr(),
                st.prio.data_ptr(), st.last_hb.data_ptr(),
                st.free.data_ptr(), st.inflight.data_ptr(),
                st.prev_live.data_ptr(), st.speed.data_ptr(),
                st.active.data_ptr(), out_i32.data_ptr(), out_b8.data_ptr(),
                scratch.data_ptr(),
                T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, max_slots,
                int(bool(use_priority)), int(bool(flush)), *ten, *spec,
                stream,
            )
        if err != 0:
            why = _COOP_ERRORS.get(err, f"CUDA error {err}")
            raise RuntimeError(f"fused_tick launch failed: {why}")
        self.launches += 1
        self._count(use_tenancy, use_spec)
        res = self._outputs(out_i32, out_b8, W, KA, KP, KR, KG, elig=elig)
        if flush:
            return st, res.arrival_slots
        return res, st

    def auction(self, packet, st, *, T, W, I, KA, KH, KF, KI, KS, KB, KP,
                KR, max_slots, use_priority, use_tenancy=False, NT=1,
                use_spec=False, KG=1):
        """An auction tick: one cooperative launch. Updates every leaf it
        writes in place, ``price`` and ``refresh`` included."""
        S = W * max_slots
        dev = self._check(packet, st, T, W, I, KA, KH, KF, KI, KS, KB,
                          use_priority, use_tenancy, NT, use_spec, KG,
                          auction_S=S)
        self.load()
        elig, ten = self._tenancy(st, dev, T, use_tenancy, NT)
        spec = self._spec(st, dev, W, use_spec)
        out_i32 = torch.empty(2 * KP + KA + KR + 1 + KG + 3,
                              dtype=torch.int32, device=dev)
        out_b8 = torch.empty(2 * W, dtype=torch.bool, device=dev)
        scratch = self._scratch_for(dev, ("auction", T, W, max_slots),
                                    self._auction_words(T, W, max_slots))
        jitter, eps = bid_scalars(EPS)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn_auction(
                packet.data_ptr(), st.sizes.data_ptr(), st.valid.data_ptr(),
                st.prio.data_ptr(), st.last_hb.data_ptr(),
                st.free.data_ptr(), st.inflight.data_ptr(),
                st.prev_live.data_ptr(), st.speed.data_ptr(),
                st.active.data_ptr(), st.price.data_ptr(),
                st.refresh.data_ptr(), out_i32.data_ptr(), out_b8.data_ptr(),
                scratch.data_ptr(),
                T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, max_slots,
                int(bool(use_priority)), WARM_ROUNDS, eps, jitter, *ten,
                *spec, stream,
            )
        if err != 0:
            why = _COOP_ERRORS.get(err, f"CUDA error {err}")
            raise RuntimeError(f"fused_tick auction launch failed: {why}")
        self.auction_launches += 1
        self._count(use_tenancy, use_spec)
        return self._outputs(out_i32, out_b8, W, KA, KP, KR, KG, aux=True,
                             elig=elig), st

    def sinkhorn(self, packet, st, *, T, W, I, KA, KH, KF, KI, KS, KB, KP,
                 KR, max_slots, use_priority, use_tenancy=False, NT=1,
                 use_spec=False, KG=1):
        """A Sinkhorn tick: one cooperative launch, on the route the batch
        tick takes for this shape (bucketed when T*W > 2**24, else dense).
        Updates the leaves it writes in place; the outputs carry the final
        potentials f and g and the effective temperature."""
        dev = self._check(packet, st, T, W, I, KA, KH, KF, KI, KS, KB,
                          use_priority, use_tenancy, NT, use_spec, KG)
        self.load()
        elig, ten = self._tenancy(st, dev, T, use_tenancy, NT)
        spec = self._spec(st, dev, W, use_spec)
        bucketed = sinkhorn_bucketed(T, W)
        n_iters = BUCKETED_ITERS if bucketed else DENSE_ITERS
        R = (N_BUCKETS if bucketed else T) + 1
        out_i32 = torch.empty(2 * KP + KA + KR + 1 + KG, dtype=torch.int32,
                              device=dev)
        out_b8 = torch.empty(2 * W, dtype=torch.bool, device=dev)
        f = torch.empty(R, dtype=torch.float32, device=dev)
        g = torch.empty(W + 1, dtype=torch.float32, device=dev)
        tau = torch.empty(1, dtype=torch.float32, device=dev)
        scratch = self._scratch_for(
            dev, ("sinkhorn", T, W, max_slots),
            self._sinkhorn_words(T, W, max_slots, int(bucketed), N_BUCKETS),
        )
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn_sinkhorn(
                packet.data_ptr(), st.sizes.data_ptr(), st.valid.data_ptr(),
                st.prio.data_ptr(), st.last_hb.data_ptr(),
                st.free.data_ptr(), st.inflight.data_ptr(),
                st.prev_live.data_ptr(), st.speed.data_ptr(),
                st.active.data_ptr(), out_i32.data_ptr(), out_b8.data_ptr(),
                f.data_ptr(), g.data_ptr(), tau.data_ptr(),
                scratch.data_ptr(),
                T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, max_slots,
                int(bool(use_priority)), int(bucketed), N_BUCKETS, n_iters,
                TAU, *ten, *spec, stream,
            )
        if err != 0:
            why = _COOP_ERRORS.get(err, f"CUDA error {err}")
            raise RuntimeError(f"fused_tick sinkhorn launch failed: {why}")
        self.sinkhorn_launches += 1
        self._count(use_tenancy, use_spec)
        res = self._outputs(out_i32, out_b8, W, KA, KP, KR, KG, elig=elig)
        return res._replace(sinkhorn_f=f, sinkhorn_g=g,
                            sinkhorn_tau=tau[0]), st

    def _buffer(self, dev: torch.device, key: tuple) -> torch.Tensor | None:
        """The scratch kept for ``key`` on ``dev``, if a launch made it."""
        return next((b for k, b in self._scratch.items()
                     if k[0].type == dev.type
                     and dev.index in (None, k[0].index) and k[1:] == key),
                    None)

    def _clocks(self, dev: torch.device, key: tuple, at: int,
                n: int) -> list[int]:
        """The n uint64 words at int32 offset ``at`` of the scratch kept
        for ``key`` on ``dev`` (a launch's stamps; reads the card)."""
        buf = self._buffer(dev, key)
        return buf[at : at + 2 * n].cpu().view(torch.int64).tolist()

    def sinkhorn_phase_ms(self, dev: torch.device, T: int, W: int,
                          max_slots: int) -> list[float]:
        """The last Sinkhorn launch's phases at this shape, in ms, from
        block 0's clock: packet and liveness, reductions, setup, the
        iterations, the rounding candidates, the capacity repair and spill,
        the compaction. Reads the card (a sync)."""
        bucketed = int(sinkhorn_bucketed(T, W))
        at = self._stamps_at(T, W, max_slots, bucketed, N_BUCKETS)
        ns = self._clocks(dev, ("sinkhorn", T, W, max_slots), at, SK_PHASES)
        return [(b - a) / 1e6 for a, b in zip(ns, ns[1:])]

    def sinkhorn_split(self, dev: torch.device, T: int, W: int,
                       max_slots: int) -> dict:
        """The last Sinkhorn launch's split at this shape, from block 0's
        clock (a probe build's stamps; reads the card, a sync), in ms:
        ``iters``, per iteration ``(f-update, its barrier, g-update, its
        barrier)`` — each update ends when the last block finished it;
        ``close``, the capacity repair and spill as ``keys`` (the
        candidates gathered with their keys), ``sort1`` and ``sort2`` (the
        repair's two sorts), ``repair`` (the kept set and the valid slots
        left), ``slots`` (the spill's admission and slot sort), ``spill``
        (its task sort and pairs; with a non-finite size or speed there,
        rank placement's own sorts); and the counts ``candidates`` (valid
        tasks not sent to slack), ``spilled`` (valid tasks the repair did
        not keep), ``pairs`` (spilled tasks the spill placed) and
        ``rank_spill`` (the spill took rank placement's own sorts); and
        ``lanes``, the lanes' parts: ``packet`` and ``liveness`` (block 0's
        part of phase 1), ``tenancy`` (the rest of it: the eligibility over
        the grid), ``fixup``, ``deficit`` and ``compaction`` (phase 7;
        the first two 0 with the lanes off)."""
        if not self.probe:
            raise RuntimeError("sinkhorn_split needs a probe build: "
                               "FusedTickKernel(probe=True)")
        bucketed = int(sinkhorn_bucketed(T, W))
        at = self._stamps_at(T, W, max_slots, bucketed, N_BUCKETS)
        ns = self._clocks(dev, ("sinkhorn", T, W, max_slots), at, SK_STAMPS)

        def ms(a, b):
            return (b - a) / 1e6

        n_iters = BUCKETED_ITERS if bucketed else DENSE_ITERS
        iters, last = [], ns[3]
        for it in range(min(n_iters, SK_ITERS)):
            f, fb, g, gb = ns[SK_ITER + 4 * it : SK_ITER + 4 * it + 4]
            iters.append((ms(last, f), ms(f, fb), ms(fb, g), ms(g, gb)))
            last = gb
        c = ns[SK_CLOSE : SK_CLOSE + 6]
        close = {"keys": ms(ns[5], c[0]), "sort1": ms(c[0], c[1]),
                 "sort2": ms(c[1], c[2]), "repair": ms(c[2], c[3]),
                 "slots": ms(c[3], c[4]), "spill": ms(c[4], c[5]),
                 "total": ms(ns[5], ns[6])}
        cand, spilled, pairs, rank_spill = ns[SK_COUNT : SK_COUNT + 4]
        return {"iters": iters, "close": close, "candidates": cand,
                "spilled": spilled, "pairs": pairs,
                "rank_spill": bool(rank_spill),
                "lanes": lane_split(ns[0], ns[1], ns[6], ns[7],
                                    ns[SK_LANES : SK_LANES + 4])}

    def rank_split(self, dev: torch.device, T: int, W: int,
                   max_slots: int) -> dict:
        """The last rank launch's phases at this shape, in ms, from block
        0's clock (a probe build's stamps; reads the card, a sync): one
        entry per name of ``RANK_PHASES`` (0 for a lane that is off),
        ``total``, and the counts of ``RANK_COUNTS``."""
        if not self.probe:
            raise RuntimeError("rank_split needs a probe build: "
                               "FusedTickKernel(probe=True)")
        ns = self._clocks(dev, ("rank", T, W, max_slots),
                          self._rank_stamps_at(T, W, max_slots), RANK_STAMPS)
        n = len(RANK_PHASES)
        out = {name: (b - a) / 1e6
               for name, a, b in zip(RANK_PHASES, ns, ns[1 : n + 1])}
        out["total"] = (ns[n] - ns[0]) / 1e6
        out.update(zip(RANK_COUNTS, ns[n + 1 : n + 1 + len(RANK_COUNTS)]))
        return out

    def rank_fallbacks(self, dev: torch.device, T: int, W: int,
                       max_slots: int) -> int:
        """Rank ticks at this shape on ``dev`` so far that took the
        full-length path (a valid slot's speed or an admitted task's size
        -inf or NaN). Reads the card (a sync)."""
        buf = self._buffer(dev, ("rank", T, W, max_slots))
        if buf is None:
            return 0
        return int(buf[self._rank_fallbacks_at(T, W, max_slots)])

    def auction_split(self, dev: torch.device, T: int, W: int,
                      max_slots: int) -> dict:
        """The last auction launch's phases at this shape, in ms, from block
        0's clock (a probe build's stamps; reads the card, a sync):
        ``open`` (packet, liveness, tenancy eligibility), ``seed`` (the
        slot sort and the opening prices), ``start`` (the first grid
        barrier), per round ``rounds`` of ``(bidders, bids, bid barrier,
        install and its barrier, collection and its barrier)`` — ``bids``
        ends when the last block finished its bids — then ``close`` (spill,
        refresh), ``end`` (fixup, deficit, compaction) and ``lanes``: the
        parts of ``open`` and ``end`` as :meth:`sinkhorn_split` gives
        them."""
        if not self.probe:
            raise RuntimeError("auction_split needs a probe build: "
                               "FusedTickKernel(probe=True)")
        at = self._auction_stamps_at(T, W, max_slots)
        ns = self._clocks(dev, ("auction", T, W, max_slots), at, AU_STAMPS)

        def ms(a, b):
            return (b - a) / 1e6

        out = {"open": ms(ns[0], ns[1]), "seed": ms(ns[1], ns[2]),
               "start": ms(ns[2], ns[3]), "rounds": []}
        last = ns[3]
        for r in range(AU_ROUNDS):
            at_r = AU_ROUND + 5 * r
            n_bid, bids, bar, inst, coll = ns[at_r : at_r + 5]
            if n_bid == 0:
                break
            out["rounds"].append((n_bid, ms(last, bids), ms(bids, bar),
                                  ms(bar, inst), ms(inst, coll)))
            last = coll
        close, end = ns[AU_CLOSE : AU_CLOSE + 2]
        out["close"] = ms(last, close)
        out["end"] = ms(close, end)
        out["total"] = ms(ns[0], end)
        out["lanes"] = lane_split(ns[0], ns[1], close, end,
                                  ns[AU_LANES : AU_LANES + 4])
        return out

    def barrier_probe(self, n: int) -> None:
        """n grid barriers alone, cooperatively on one block per SM (not
        counted as a launch)."""
        self.load()
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn_barrier(n, stream)
        if err != 0:
            raise RuntimeError(f"barrier probe failed: CUDA error {err}")

    def math_probe(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``expf`` and ``logf`` of a CUDA float32 vector, compiled as the
        Sinkhorn branch compiles them (not counted as a launch)."""
        check_arg(x, "x", torch.float32, x.shape[0], x.device)
        self.load()
        e, lg = torch.empty_like(x), torch.empty_like(x)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = self._fn_math(x.data_ptr(), e.data_ptr(), lg.data_ptr(),
                                x.shape[0], stream)
        if err != 0:
            raise RuntimeError(f"math probe launch failed: CUDA error {err}")
        return e, lg


#: the process's one instance: its ``launches``, ``auction_launches``,
#: ``sinkhorn_launches``, ``tenancy_launches`` and ``spec_launches`` are the
#: library's counts
KERNEL = FusedTickKernel()


def fused_resident_tick(
    packet: torch.Tensor,
    st: _ResidentState,
    *,
    flush: bool = False,
    placement: str = "rank",
    **statics,
):
    """One resident tick (``flush=False``: returns ``(ResidentTickOutput,
    state)``) or one delta application alone (``flush=True``: returns
    ``(state, arrival_slots)``). On CUDA tensors the kernel updates ``st``
    in place and returns it; on CPU tensors the plain version returns a
    new state and leaves ``st`` untouched. ``placement`` is ``"rank"``,
    ``"auction"`` or ``"sinkhorn"``; a flush is the same for all three."""
    check_placement(placement)
    if packet.device.type == "cuda":
        if placement == "auction" and not flush:
            return KERNEL.auction(packet, st, **statics)
        if placement == "sinkhorn" and not flush:
            return KERNEL.sinkhorn(packet, st, **statics)
        return KERNEL(packet, st, flush=flush, **statics)
    if packet.device.type != "cpu":
        raise ValueError(f"no fused tick for device {packet.device}")
    if flush:
        statics = {k: v for k, v in statics.items()
                   if k not in ("KP", "KR", "max_slots")}
        return _flush_kernel_impl(packet, st, **statics)
    return _resident_tick_impl(packet, st, placement=placement, **statics)
