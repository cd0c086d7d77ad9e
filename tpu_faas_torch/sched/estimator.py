"""Runtime estimation: learned task sizes and worker speeds for the cost
matrix.

BASELINE.json's north star defines placement cost over "task-size estimates,
worker capacity, and heartbeat-derived liveness". Capacity and liveness are
measured; this module closes the loop on the remaining two inputs, which
round 3 left as client-supplied hints defaulting to 1.0.

**Task size** is estimated hierarchically — the reference's own workload
corpus varies runtime by parameter WITHIN a function
(client_performance.py:19-92: ``sleep_n``, ``arithmetic(n)``), so one
number per function is the wrong shape. Three levels, most specific wins:

1. **exact-param EWMA** — keyed by (fn digest, param digest): tasks that
   repeat the same call see their own runtime, so a function mixing 1 ms
   and 10 s parameterizations separates cleanly (bench config 8's
   mixed-param leg pins the makespan win over the fn-level collapse);
2. **per-function byte regression** — an online log-log fit of runtime vs
   serialized-param bytes, used for params never seen before when the
   function's observed byte spread actually carries signal (sorts and
   other data-sized workloads; a constant-byte workload like ``sleep(n)``
   shows no spread and skips this level);
3. **per-function EWMA** — the round-4 fallback, one number per function.

**Worker speed** is an EWMA of (estimated size / observed execution time)
keyed by a STABLE worker identity: our workers mint a ``token`` at process
start and carry it on REGISTER and RECONNECT, so a zombie that reconnects
under a fresh socket identity keeps its grade, the grades survive
dispatcher restarts through the store, and ``--shared`` siblings adopt
each other's gradings (reference-era workers send no token and degrade to
socket-identity grading, dropped on purge as before).

The two estimates are mutually referential (a runtime observation is
``size / speed``), resolved the standard alternating way: a size
observation is normalized by the CURRENT speed estimate of the worker that
ran it, and speed observations only begin once the size estimate they
divide by has a few samples behind it. The absolute scale is a gauge
freedom — the rank/auction/Sinkhorn kernels are invariant to a global
rescale — so speeds are merely clamped to a sane band.

Observations use the WORKER-measured execution time (``elapsed`` on the
RESULT message): the dispatcher-side dispatch->result interval would fold
in pool queueing and transport. FAILED results are not observed — failures
often short-circuit and would drag estimates toward zero.

**The ungraded-worker regime (deliberate, pinned by tests):** a workload
whose params NEVER repeat, whose byte sizes carry no spread (the byte
regression declines), AND whose runtimes genuinely vary (fn-level
log-variance over ``_REG_MAX_Y_VAR``) leaves NO trustworthy per-task
reference to divide a speed observation by — the exact-param level never
settles, the regression never fits, and the fn-level mean would mis-grade
every worker that happens to draw small (or large) params. In that regime
``observe`` keeps learning SIZES but refuses to grade workers: fleet
speeds stay at the 1.0 prior and placement degrades to size-only rank
matching — still the batched Monge pairing, just speed-blind. This is the
safe floor, not a bug: a wrong speed grade mis-places every future task
on that worker, while no grade merely forgoes the heterogeneity win.
tests/test_estimator.py::test_ungraded_regime_speeds_stay_prior pins it.

Estimates survive restarts through the store (two hashes, pipelined
write-behind, best-effort under outages): a dispatcher that restarts
mid-day re-learns nothing — functions NOR fleet grades.
"""

from __future__ import annotations

import hashlib
import math
import time

from tpu_faas_torch.utils.logging import get_logger

log = get_logger("sched.estimator")

#: store hash holding fn_digest -> "est:count[:n:sx:sy:sxx:sxy]" (seconds
#: at unit speed; the optional tail is the byte-regression accumulator)
FN_STATS_KEY = "faas:fn_stats"
#: store hash holding worker token -> "speed" (unit-relative EWMA)
WORKER_STATS_KEY = "faas:worker_stats"

#: speed estimates are confined to this band: a worker 400x faster or
#: slower than the fleet median is a measurement artifact (clock glitch,
#: empty-function timing noise), and an unbounded EWMA would let the
#: size/speed gauge run away
_SPEED_LO, _SPEED_HI = 0.05, 20.0

#: exact-param estimates are capped (evict-oldest): the param keyspace is
#: client-controlled and unbounded, unlike the function keyspace
_PARAM_CAP = 50_000

#: byte-regression gates: a fit extrapolates only after this many samples
#: AND when the byte feature actually varies (log1p-space variance)
_REG_MIN_SAMPLES = 8
_REG_MIN_VAR = 1e-3
#: fallback gate for the grading reference (ADVICE r5): when the byte
#: regression DECLINES (constant-byte workload — var_x under _REG_MIN_VAR)
#: but the function's observed RUNTIME spread is small (log-space variance
#: of size observations under this bound, ~ +/-35% at one sigma), the
#: fn-level EWMA is representative of every parameterization and worker
#: speed learning degrades to it instead of stopping dead
_REG_MAX_Y_VAR = 0.1
#: predictions are clamped to this factor around the fn-level EWMA: a
#: regression extrapolating far outside everything observed is noise
_REG_CLAMP = 64.0


def fn_digest(fn_payload: str) -> str:
    """Stable identity for "the same function": a short digest of the
    serialized payload. Collision-safe at 16 hex chars for any plausible
    function count; identical across producers, restarts, and hosts. Also
    used for param payloads (same stability argument)."""
    return hashlib.blake2b(
        fn_payload.encode("ascii", "replace"), digest_size=8
    ).hexdigest()


def _ident(worker_id) -> str:
    """Normalize a worker identity (stable token str, or raw socket
    identity bytes for tokenless reference-era workers) to a dict key."""
    if isinstance(worker_id, bytes):
        return worker_id.hex()
    return str(worker_id)


class RuntimeEstimator:
    """Joint estimation of function runtimes and worker speeds.

    All methods are cheap dict operations on the dispatcher's serve loop;
    persistence batches into one store write per ``persist_period``
    seconds.
    """

    def __init__(
        self,
        store=None,
        alpha: float = 0.25,
        speed_alpha: float = 0.1,
        speed_min_samples: int = 3,
        persist_period: float = 10.0,
        clock=time.monotonic,
    ) -> None:
        self.store = store
        self.alpha = float(alpha)
        self.speed_alpha = float(speed_alpha)
        #: observations a size estimate needs before it is trusted to
        #: grade WORKERS (speed updates divide by it)
        self.speed_min_samples = int(speed_min_samples)
        self.persist_period = float(persist_period)
        self.clock = clock
        self._fn_est: dict[str, float] = {}
        self._fn_count: dict[str, int] = {}
        #: per-fn online regression sums over (x=log1p(param_bytes),
        #: y=log(size)): [n, sx, sy, sxx, sxy, syy]. The 6th term (syy)
        #: powers the runtime-spread fallback gate; records persisted by
        #: pre-r6 builds lack it and load with the -1.0 "unknown" sentinel,
        #: which keeps the fallback conservatively off until re-learned.
        self._fn_reg: dict[str, list[float]] = {}
        #: exact-param estimates, keyed "fn_digest:param_digest"
        self._param_est: dict[str, float] = {}
        self._param_count: dict[str, int] = {}
        self._speed_est: dict[str, float] = {}
        #: tokens flagged EPHEMERAL (worker self-minted a uuid because it
        #: was launched without --token): graded in memory like any stable
        #: token — the grade survives reconnects within the process's life
        #: — but never persisted to WORKER_STATS_KEY, and forgotten when
        #: the worker is purged. Without this, every ad-hoc worker restart
        #: leaked one never-pruned store entry that sibling adoption then
        #: loaded into every dispatcher forever (ADVICE r5, medium).
        self._ephemeral: set[str] = set()
        self._dirty: set[str] = set()
        self._dirty_speeds: set[str] = set()
        self._last_persist = clock()
        self.n_observations = 0
        if store is not None:
            self._load()

    # -- persistence -------------------------------------------------------
    def _load(self) -> None:
        try:
            fields = self.store.hgetall(FN_STATS_KEY)
            speed_fields = self.store.hgetall(WORKER_STATS_KEY)
        except Exception as exc:  # outage at startup: learn from scratch
            log.warning("estimator stats load skipped (%s)", exc)
            return
        for key, raw in fields.items():
            parts = raw.split(":")
            try:
                est, count = float(parts[0]), int(parts[1])
            except (ValueError, IndexError):
                continue
            if est > 0 and count > 0:
                self._fn_est[key] = est
                self._fn_count[key] = count
            if len(parts) >= 7:
                try:
                    reg = [float(p) for p in parts[2:8]]
                except ValueError:
                    continue
                if len(reg) < 6:
                    reg.append(-1.0)  # legacy record: spread unknown
                if reg[0] > 0:
                    self._fn_reg[key] = reg
        for token, raw in speed_fields.items():
            try:
                speed = float(raw)
            except ValueError:
                continue
            if _SPEED_LO <= speed <= _SPEED_HI:
                self._speed_est[token] = speed
        if self._fn_est or self._speed_est:
            log.info(
                "loaded %d function-runtime and %d worker-speed estimates",
                len(self._fn_est),
                len(self._speed_est),
            )

    def maybe_persist(self, force: bool = False) -> int:
        """Write-behind dirty estimates; call from the serve loop (cheap
        no-op between periods). Returns entries written. Best-effort: an
        outage drops nothing — entries stay dirty for the next period.
        ``force`` skips the period gate — the graceful-shutdown flush, so
        a restart loses at most a crash's final window, not every clean
        stop's. Each period also ADOPTS speed gradings persisted by
        ``--shared`` siblings for workers this dispatcher hasn't graded
        itself (a worker that failed over brings its grade along)."""
        if self.store is None or not (self._dirty or self._dirty_speeds):
            return 0
        if not force and self.clock() - self._last_persist < self.persist_period:
            return 0
        items = {}
        for key in self._dirty:
            if key not in self._fn_est:
                continue
            value = f"{self._fn_est[key]:.6g}:{self._fn_count[key]}"
            reg = self._fn_reg.get(key)
            if reg is not None:
                value += ":" + ":".join(f"{v:.8g}" for v in reg)
            items[key] = value
        speed_items = {
            token: f"{self._speed_est[token]:.6g}"
            for token in self._dirty_speeds
            if token in self._speed_est
        }
        try:
            if items:
                self.store.hset(FN_STATS_KEY, items)
            if speed_items:
                self.store.hset(WORKER_STATS_KEY, speed_items)
            # sibling adoption: one small hash read per period
            persisted = self.store.hgetall(WORKER_STATS_KEY)
        except Exception as exc:
            log.debug("estimator persist deferred (%s)", exc)
            return 0
        for token, raw in persisted.items():
            if token in self._speed_est:
                continue
            if len(self._speed_est) >= _PARAM_CAP:
                break  # adoption never grows memory past the shared cap
            try:
                speed = float(raw)
            except ValueError:
                continue
            if _SPEED_LO <= speed <= _SPEED_HI:
                self._speed_est[token] = speed
        self._last_persist = self.clock()
        self._dirty.clear()
        self._dirty_speeds.clear()
        return len(items) + len(speed_items)

    # -- queries (intake path) ---------------------------------------------
    def size_for(
        self,
        digest: str,
        param_digest: str | None = None,
        param_bytes: int | None = None,
    ) -> float | None:
        """Learned size for this (function, params), most specific level
        first; None when the function is entirely unobserved."""
        if param_digest is not None:
            exact = self._param_est.get(f"{digest}:{param_digest}")
            if exact is not None:
                return exact
        fn_level = self._fn_est.get(digest)
        if param_bytes is not None and fn_level is not None:
            predicted = self._predict_from_bytes(digest, param_bytes)
            if predicted is not None:
                # clamp: a fit extrapolating far beyond everything this
                # function ever showed is noise, not signal
                return min(
                    max(predicted, fn_level / _REG_CLAMP),
                    fn_level * _REG_CLAMP,
                )
        return fn_level

    def _runtime_spread_small(self, digest: str) -> bool:
        """True when this function's observed size observations cluster
        tightly (log-space variance under _REG_MAX_Y_VAR over at least the
        regression-sample floor): its fn-level EWMA then represents every
        parameterization well enough to grade workers against. False on
        too few samples, or on legacy persisted records whose accumulator
        predates the syy term (sentinel -1.0)."""
        reg = self._fn_reg.get(digest)
        if reg is None or len(reg) < 6:
            return False
        n, _sx, sy, _sxx, _sxy, syy = reg
        if n < _REG_MIN_SAMPLES or syy < 0:
            return False
        var_y = syy / n - (sy / n) ** 2
        return var_y < _REG_MAX_Y_VAR

    def _predict_from_bytes(
        self, digest: str, param_bytes: int
    ) -> float | None:
        reg = self._fn_reg.get(digest)
        if reg is None:
            return None
        n, sx, sy, sxx, sxy = reg[:5]
        if n < _REG_MIN_SAMPLES:
            return None
        var_x = sxx / n - (sx / n) ** 2
        if var_x < _REG_MIN_VAR:
            return None  # constant-byte workload: bytes carry no signal
        slope = (sxy / n - (sx / n) * (sy / n)) / var_x
        intercept = sy / n - slope * (sx / n)
        x = math.log1p(max(int(param_bytes), 0))
        try:
            return math.exp(intercept + slope * x)
        except OverflowError:
            return None

    def default_size(self) -> float | None:
        """Prior for a function with no observations yet: the mean of the
        known estimates, so unknown tasks rank mid-field rather than
        polluting the batch with payload-byte magnitudes. None while
        nothing at all has been learned (callers then keep the round-3
        payload-bytes fallback — a consistent scale within the batch)."""
        if not self._fn_est:
            return None
        return sum(self._fn_est.values()) / len(self._fn_est)

    def speed_for(self, worker_id) -> float:
        """Current speed estimate for a worker identity (1.0 prior)."""
        return self._speed_est.get(_ident(worker_id), 1.0)

    # -- observations (result path) ----------------------------------------
    def observe(
        self,
        digest: str,
        elapsed: float,
        worker_id,
        param_digest: str | None = None,
        param_bytes: int | None = None,
    ) -> None:
        """Fold one completed execution into every estimate level."""
        if not (elapsed > 0.0) or elapsed != elapsed:  # NaN guard
            return
        self.n_observations += 1
        ident = _ident(worker_id)
        speed = self._speed_est.get(ident, 1.0)
        size_obs = elapsed * speed

        # level 3: per-function EWMA
        prev = self._fn_est.get(digest)
        count = self._fn_count.get(digest, 0)
        if prev is None:
            self._fn_est[digest] = size_obs
        else:
            self._fn_est[digest] = (
                self.alpha * size_obs + (1.0 - self.alpha) * prev
            )
        self._fn_count[digest] = count + 1
        self._dirty.add(digest)

        # level 2: per-function byte regression (log-log). The grading
        # reference is computed BEFORE folding this observation in — like
        # the prev-based levels, a worker must never be graded against a
        # fit its own observation just pulled toward itself.
        reg_ref = (
            self._predict_from_bytes(digest, param_bytes)
            if param_bytes is not None
            else None
        )
        if param_bytes is not None and size_obs > 0:
            x = math.log1p(max(int(param_bytes), 0))
            y = math.log(size_obs)
            reg = self._fn_reg.get(digest)
            if reg is None:
                reg = self._fn_reg[digest] = [0.0] * 6
            elif len(reg) < 6 or reg[5] < 0:
                # legacy accumulator (pre-syy record): restart it whole —
                # mixing old counts with a fresh syy would fabricate a
                # too-small variance, and re-learning the fit costs only
                # _REG_MIN_SAMPLES observations
                reg = self._fn_reg[digest] = [0.0] * 6
            reg[0] += 1.0
            reg[1] += x
            reg[2] += y
            reg[3] += x * x
            reg[4] += x * y
            reg[5] += y * y

        # level 1: exact-param EWMA
        prev_param = None
        count_param = 0
        if param_digest is not None:
            pkey = f"{digest}:{param_digest}"
            prev_param = self._param_est.get(pkey)
            count_param = self._param_count.get(pkey, 0)
            if prev_param is None:
                self._param_est[pkey] = size_obs
                if len(self._param_est) > _PARAM_CAP:
                    # evict oldest (dict insertion order): the param
                    # keyspace is client-controlled and must stay bounded
                    oldest = next(iter(self._param_est))
                    self._param_est.pop(oldest, None)
                    self._param_count.pop(oldest, None)
            else:
                self._param_est[pkey] = (
                    self.alpha * size_obs + (1.0 - self.alpha) * prev_param
                )
            self._param_count[pkey] = count_param + 1

        # grade the worker only against a settled size estimate, and not
        # against the very observation that just moved it (use prev). The
        # reference estimate must match THIS task's parameterization — a
        # mixed-param function's fn-level mean would mis-grade every
        # worker that happens to draw the small (or large) params — so:
        # exact-param prev when settled, else the byte-regression
        # prediction (params never repeat but bytes carry signal), and the
        # fn-level prev ONLY for param-blind callers (legacy paths), whose
        # per-fn estimate genuinely is the task size.
        if count_param >= self.speed_min_samples and prev_param is not None:
            ref = prev_param
        elif param_digest is not None:
            ref = reg_ref  # pre-update fit, see above
            if ref is None or ref <= 0:
                # the byte regression declined (constant-byte workload, or
                # not enough samples yet). When this function's runtime
                # spread is demonstrably SMALL, the fn-level prev is a
                # faithful reference for any parameterization — fall back
                # to it so speed learning degrades instead of stopping
                # (ADVICE r5: the old unconditional return left whole
                # constant-byte workloads grading no workers at all). A
                # genuinely mixed-runtime function keeps the return: its
                # fn-level mean would mis-grade every worker that happens
                # to draw small (or large) params.
                if (
                    prev is not None
                    and count >= self.speed_min_samples
                    and self._runtime_spread_small(digest)
                ):
                    ref = prev
                else:
                    return
        elif prev is not None and count >= self.speed_min_samples:
            ref = prev
        else:
            return
        speed_obs = ref / elapsed
        speed_new = (
            self.speed_alpha * speed_obs + (1.0 - self.speed_alpha) * speed
        )
        self._speed_est[ident] = min(max(speed_new, _SPEED_LO), _SPEED_HI)
        # only STABLE identities (token strs) persist and share: a socket
        # identity (bytes) is never seen again after its worker dies, and
        # persisting it would both grow WORKER_STATS_KEY with garbage and
        # let the sibling-adoption read resurrect entries forget_worker
        # just dropped. Ephemeral tokens (self-minted uuid defaults) are
        # held to the same rule: durable grades are for operator/deploy
        # tokens that will be presented again after a process death.
        if isinstance(worker_id, str) and ident not in self._ephemeral:
            self._dirty_speeds.add(ident)

    def note_ephemeral(self, worker_id) -> None:
        """Flag an identity as ephemeral (a self-minted uuid token): its
        grade stays usable in memory but is never persisted, and the purge
        path forgets it. The set is bounded by the same cap as every other
        client-controlled keyspace here."""
        if len(self._ephemeral) < _PARAM_CAP:
            self._ephemeral.add(_ident(worker_id))

    def is_ephemeral(self, worker_id) -> bool:
        return _ident(worker_id) in self._ephemeral

    def forget_worker(self, worker_id) -> None:
        """Drop an EPHEMERAL identity's grade (tokenless reference-era
        worker purged — its socket identity is never seen again — or a
        purged worker whose self-minted uuid token was flagged ephemeral).
        Callers must NOT invoke this for DURABLE token-stable workers — a
        purged worker that reconnects (or re-registers after a
        crash-restart on the same machine) keeps its grade, in memory and
        in the store."""
        ident = _ident(worker_id)
        self._speed_est.pop(ident, None)
        self._dirty_speeds.discard(ident)
        self._ephemeral.discard(ident)

    def stats(self) -> dict:
        return {
            "functions_learned": len(self._fn_est),
            "param_variants_learned": len(self._param_est),
            "workers_graded": len(self._speed_est),
            "observations": self.n_observations,
        }
