"""The resident auction tick of the PyTorch port against the TPU kernel.

The JAX side is the fused Pallas resident tick (kernel B1) with
``placement="auction"``, run the way the JAX suite runs it on the CPU: under
the Pallas interpreter. The port side is ``fused_tick.fused_resident_tick``
on CPU tensors, which runs the plain version of the port's CUDA auction
branch. Inputs have exact products (sizes k/8, speeds in {0.5, 1, 2, 4},
prices k/16), so a compiler's contraction of a product into an add cannot
move a bid. Contracts: every integer output and state leaf exactly equal;
``price`` within 1e-5, the bid kernel's contract.

Also here: the order of the rank-dual seed's reversed cumsum that the CUDA
kernel reproduces, the library hash over included headers, and the
checks the CUDA wrappers make before they launch.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_resident import leaves_equal
from tpu_faas.sched import pallas_fused as jfused
from tpu_faas.sched import resident as jres
from tpu_faas_torch import build
from tpu_faas_torch.sched import auction as tau
from tpu_faas_torch.sched import fused_tick
from tpu_faas_torch.sched import resident as tres

f32, i32 = np.float32, np.int32
_SPEEDS = np.array([0.5, 1.0, 2.0, 4.0], f32)


def _case(seed, use_priority, refresh, hostile=False, T=128, W=16, I=64,
          K=4, KA=8, KH=8, KF=8, KI=16, KS=8, KB=8):
    """A random resident state and one delta packet, every value with
    exact products. ``hostile`` adds wrap-once negative and out-of-range
    indices and saturating, truncating and NaN counts."""
    rng = np.random.default_rng(seed)
    now = 50.0
    leaves = dict(
        sizes=(rng.integers(1, 33, T) / 8).astype(f32),
        valid=rng.random(T) < 0.6,
        prio=rng.integers(-2, 3, T).astype(i32),
        tenant=np.zeros(T, i32),
        last_hb=(now - rng.uniform(0.0, 12.0, W)).astype(f32),
        free=rng.integers(-1, K + 2, W).astype(i32),
        inflight=np.where(rng.random(I) < 0.5, -1,
                          rng.integers(0, W, I)).astype(i32),
        prev_live=rng.random(W) < 0.9,
        speed=rng.choice(_SPEEDS, W),
        active=rng.random(W) < 0.9,
        price=(rng.integers(0, 32, W * K) / 16).astype(f32),
        t_deficit=np.zeros(1, f32),
        infl_start=np.zeros(1, f32),
        infl_pred=np.zeros(1, f32),
        avoid=np.full(1, -1, i32),
        refresh=np.asarray(refresh),
    )
    lanes = 2 if use_priority else 1
    p = np.zeros(9 + KA * lanes + 2 * (KH + KF + KI + KS + KB), f32)
    counts = [int(rng.integers(1, k + 1)) for k in (KA, KH, KF, KI, KS, KB)]
    if hostile:
        counts[1] = KH  # the count saturates below: keep every lane real
    p[0], p[1:7], p[8] = now, counts, 10.0
    off = 9
    p[off : off + counts[0]] = rng.integers(1, 33, counts[0]) / 8
    off += KA
    if use_priority:
        p[off : off + counts[0]] = rng.integers(-2, 3, counts[0])
        off += KA
    for n, k, N, vals in (
        (counts[1], KH, W, lambda n: now - rng.uniform(0.0, 12.0, n)),
        (counts[2], KF, W, lambda n: rng.integers(-2, 3, n)),
        (counts[3], KI, I, lambda n: rng.integers(-1, W, n)),
        (counts[4], KS, W, lambda n: rng.choice(_SPEEDS, n)),
        (counts[5], KB, W, lambda n: (rng.random(n) < 0.8).astype(f32)),
    ):
        idx = rng.choice(N, n, replace=False)
        if hostile:
            idx = np.where(rng.random(n) < 0.3, idx - N, idx)
            idx[0] = N + 3 if n > 1 else idx[0]
            idx[-1] = -N - 2 if n > 2 else idx[-1]
        p[off : off + n] = idx
        off += k
        p[off : off + n] = vals(n)
        off += k
    if hostile:
        p[2] = 1e10  # saturates to INT32_MAX: every lane of KH applies
        p[3] = -5.7  # truncates to -5: no free deltas
        p[1] = np.nan  # NaN converts to 0: no arrivals
    statics = dict(T=T, W=W, I=I, KA=KA, KH=KH, KF=KF, KI=KI, KS=KS, KB=KB,
                   KP=32, KR=8, max_slots=K, use_priority=use_priority)
    return leaves, p, statics


def _tick_both(leaves, packet, statics):
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    want, wst = jfused.fused_resident_tick(
        jnp.asarray(packet), jst, interpret=True, placement="auction",
        **statics,
    )
    got, gst = fused_tick.fused_resident_tick(
        torch.from_numpy(packet), tres.state_from_numpy(leaves, "cpu"),
        placement="auction", **statics,
    )
    return want, wst, got, gst


def _assert_tick_matches(want, wst, got, gst):
    for field in want._fields:
        np.testing.assert_array_equal(tres.to_host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    g = tres.state_to_numpy(gst)
    for field in wst._fields:
        w = np.asarray(getattr(wst, field))
        if field == "price":
            np.testing.assert_allclose(g[field], w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g[field], w, err_msg=field)


@pytest.mark.parametrize("hostile", [False, True], ids=["plain", "hostile"])
@pytest.mark.parametrize("use_priority", [False, True])
@pytest.mark.parametrize("refresh", [True, False], ids=["cold", "warm"])
def test_auction_tick_matches_fused_kernel(refresh, use_priority, hostile):
    """One resident auction tick from a random state: the port's tick
    against the TPU kernel under the Pallas interpreter."""
    leaves, packet, statics = _case(7 + int(hostile), use_priority, refresh,
                                    hostile=hostile)
    want, wst, got, gst = _tick_both(leaves, packet, statics)
    assert (np.asarray(want.placed_slots) >= 0).any()
    _assert_tick_matches(want, wst, got, gst)
    # the round, spilled and bidder-row counts, which JAX's tick does not
    # return
    rounds = int(got.auction_rounds)
    assert 0 < rounds <= tau.WARM_ROUNDS
    assert int(got.auction_spilled) >= 0
    assert rounds <= int(got.auction_bid_rows) <= rounds * leaves["valid"].size
    assert bool(gst.refresh) == bool(wst.refresh)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auction_ticks_in_sequence_match_fused_kernel(seed):
    """Three ticks in a row, each from the state the last one left, so the
    carried prices and refresh flag of one tick open the next."""
    leaves, packet, statics = _case(20 + seed, False, True)
    for _ in range(3):
        want, wst, got, gst = _tick_both(leaves, packet, statics)
        _assert_tick_matches(want, wst, got, gst)
        # carry JAX's state on, and free the slots this tick consumed
        leaves = {f: np.array(getattr(wst, f)) for f in wst._fields}
        leaves["free"] = np.maximum(leaves["free"], 2).astype(i32)


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# the JAX suite's scripted history (tests/test_sched_fused.py)
_SCRIPT = [
    {
        "register": [(b"w0", 4, 1.0), (b"w1", 4, 2.0), (b"w2", 2, 3.0)],
        "arrivals": [(f"t{i}", 0.5 + 0.25 * i) for i in range(6)],
    },
    {
        "hb": [b"w0", b"w1", b"w2"],
        "results": ["t0", "t3"],
        "arrivals": [("t6", 2.0), ("t7", 0.1)],
    },
    {"hb": [b"w0", b"w1"], "dt": 11.0, "arrivals": [("t8", 1.3)]},
    {
        "register": [(b"w2", 2, 3.0)],
        "hb": [b"w0", b"w1"],
        "arrivals": [("t9", 0.9), ("t10", 4.0)],
    },
]
_SMALL = dict(max_workers=32, max_pending=64, max_inflight=128, max_slots=4,
              KA=8, KP=16, KR=8, placement="auction")


def _drive(rs, script):
    views = []
    for ev in script:
        rs.clock.t += ev.get("dt", 0.1)
        for wid, procs, speed in ev.get("register", ()):
            rs.register(wid, procs, speed=speed)
        for wid in ev.get("hb", ()):
            rs.heartbeat(wid)
        for tid, size in ev.get("arrivals", ()):
            rs.pending_add(tid, size)
        for tid in ev.get("results", ()):
            row = rs.inflight_done(tid)
            if row is not None:
                rs.release_slot(row)
        rs.tick_resident()
        while (r := rs.resolve_next()) is not None:
            views.append((sorted(r.placed), sorted(r.redispatch_slots),
                          sorted(int(x) for x in r.purged_rows), r.rejected,
                          r.n_pending))
            for tid, row in r.placed:
                rs.inflight_add(tid, row)
    return views


def test_scripted_history_matches_fused_kernel():
    """The scripted history — arrivals, results, heartbeat churn, a purge
    and reconnect — resolves identically through the port's resident
    auction and JAX's interpreted fused tick, and leaves the same state."""
    a = jres.ResidentScheduler(clock=_Clock(), tick_backend="fused_interpret",
                               **_SMALL)
    b = tres.ResidentScheduler(clock=_Clock(), device="cpu", **_SMALL)
    va, vb = _drive(a, _SCRIPT), _drive(b, _SCRIPT)
    assert va == vb
    assert any(p for p, *_ in va) and any(rd for _, rd, *_ in va)
    assert any(pr for _, _, pr, *_ in va)
    w, g = a._r_state, tres.state_to_numpy(b._r_state)
    for field in ("valid", "prio", "free", "inflight", "prev_live",
                  "active", "last_hb", "speed", "refresh"):
        np.testing.assert_array_equal(g[field], np.asarray(getattr(w, field)),
                                      err_msg=field)
    np.testing.assert_allclose(g["sizes"], np.asarray(w.sizes), atol=1e-6)
    np.testing.assert_allclose(g["price"], np.asarray(w.price), atol=1e-5)


def test_rank_dual_seed_sums_in_float64_from_the_end():
    """The order the CUDA kernel reproduces: the seed's reversed cumsum is
    one serial float64 running sum from the last position, each prefix
    rounded to float32 — bit for bit at the headline's 32,768 slots. A
    float32 running sum gives other bits, so the order is observable."""
    W, K = 4096, 8
    S = W * K
    rng = np.random.default_rng(11)
    sizes = rng.lognormal(0.0, 1.0, 40_000).astype(f32)
    valid = np.ones(40_000, bool)
    speed = rng.uniform(0.5, 4.0, W).astype(f32)
    free = rng.integers(0, K + 1, W).astype(i32)
    args = [torch.from_numpy(a) for a in (valid, speed, free)]
    _, _, _, speed_key, order, n_match, admitted = tau._expand_and_square(
        args[0], args[1], args[2], torch.ones(W, dtype=torch.bool), K)
    got = tau._rank_dual_seed(torch.from_numpy(sizes), admitted, speed_key,
                              order, n_match).numpy()
    # the contributions, op by op in float32 as the plain version takes them
    n = int(n_match)
    inv = (f32(1.0) / np.maximum(speed_key[order].numpy(), f32(1e-6)))
    size_sorted = np.sort(np.where(admitted.numpy(), sizes, -np.inf))[::-1]
    size_sorted = np.maximum(size_sorted, f32(0.0)).astype(f32)
    mid = np.zeros(S, f32)
    mid[: S - 1] = f32(0.5) * (size_sorted[: S - 1] + size_sorted[1:S])
    diff = np.zeros(S, f32)
    diff[:-1] = inv[1:] - inv[:-1]
    contrib = np.where(np.arange(S) + 1 < n, mid * np.maximum(diff, f32(0)),
                       f32(0)).astype(f32)
    want = np.cumsum(contrib[::-1].astype(np.float64))[::-1].astype(f32)
    p_sorted = np.zeros(S, f32)
    p_sorted[:] = got[order.numpy()]
    np.testing.assert_array_equal(p_sorted, want)
    serial_f32 = np.cumsum(contrib[::-1], dtype=f32)[::-1]
    assert (serial_f32 != want).any()


def test_resident_auction_on_cuda_needs_a_card():
    """A CUDA resident auction is ported: without a GPU it raises the
    device module's no-CUDA error, not NotImplementedError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the scheduler builds")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tres.ResidentScheduler(max_workers=16, max_pending=64,
                               placement="auction", device="cuda")


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes gives the source's library
    another name, so a stale library is never loaded; a header the source
    does not include leaves the name alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in ("fused_tick", "bid_top2")}
    (csrc / "unrelated.cuh").write_text("// not included anywhere\n")
    assert {n: build.library_path(n) for n in before} == before
    header = csrc / "bid_top2.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for n in before:
        assert build.library_path(n) != before[n], n


def test_auction_wrapper_validates_price_and_refresh():
    """The CUDA auction wrapper checks the carried leaves before it builds
    or launches anything."""
    leaves, packet, statics = _case(3, False, True)
    st = tres.state_from_numpy(leaves, "cpu")
    kernel = fused_tick.FusedTickKernel()
    with pytest.raises(ValueError, match="price"):
        kernel.auction(torch.from_numpy(packet),
                       st._replace(price=st.price[:-1]), **statics)
    with pytest.raises(ValueError, match="price"):
        kernel.auction(torch.from_numpy(packet),
                       st._replace(price=st.price.double()), **statics)
    with pytest.raises(ValueError, match="refresh"):
        kernel.auction(torch.from_numpy(packet),
                       st._replace(refresh=torch.ones(2, dtype=torch.bool)),
                       **statics)
    assert kernel.auction_launches == 0 and kernel._fn is None


@pytest.mark.cuda
def test_auction_kernel_matches_plain_on_card():
    """The CUDA auction branch against its plain version on the card:
    every output and state leaf exactly equal, rounds and spills too. The
    kernel alone reports whether it took the full-length path: here never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    for refresh in (True, False):
        for hostile in (False, True):
            leaves, packet, statics = _case(5, use_priority=hostile,
                                            refresh=refresh, hostile=hostile)
            pkt = torch.from_numpy(packet).cuda()
            want, wst = tres._resident_tick_impl(
                pkt, tres.state_from_numpy(leaves, "cuda"),
                placement="auction", **statics)
            got, gst = fused_tick.fused_resident_tick(
                pkt, tres.state_from_numpy(leaves, "cuda"),
                placement="auction", **statics)
            assert int(got.auction_full_length) == 0
            assert leaves_equal(got._replace(auction_full_length=None), want)
            assert leaves_equal(gst, wst)


def _quiet(packet):
    """The packet with every count 0: no arrival and no delta, so the
    state alone decides the tick."""
    p = packet.copy()
    p[1:7] = 0
    return p


def _saturated(seed, T, W, K, n_free, refresh, price_hi=0.0, KP=1024):
    """A fleet as the benchmark's auction cell holds it: every worker live
    and busy but for about ``n_free`` free processes, 95% of the pending
    slots valid, lognormal sizes, speeds U(0.5, 4), carried prices U(0,
    price_hi), and a quiet packet."""
    rng = np.random.default_rng(seed)
    now = 50.0
    free = np.zeros(W, i32)
    np.add.at(free, rng.integers(0, W, n_free), 1)
    leaves = dict(
        sizes=rng.lognormal(0.3, 1.0, T).astype(f32),
        valid=rng.random(T) < 0.95,
        prio=np.zeros(T, i32),
        tenant=np.zeros(T, i32),
        last_hb=np.full(W, now, f32),
        free=np.minimum(free, K).astype(i32),
        inflight=np.full(W * K, -1, i32),
        prev_live=np.ones(W, bool),
        speed=rng.uniform(0.5, 4.0, W).astype(f32),
        active=np.ones(W, bool),
        price=rng.uniform(0.0, price_hi, W * K).astype(f32),
        t_deficit=np.zeros(1, f32),
        infl_start=np.zeros(1, f32),
        infl_pred=np.zeros(1, f32),
        avoid=np.full(1, -1, i32),
        refresh=np.asarray(refresh),
    )
    K8 = 8
    p = np.zeros(9 + K8 + 2 * 5 * K8, f32)
    p[0], p[8] = now, 10.0
    statics = dict(T=T, W=W, I=W * K, KA=K8, KH=K8, KF=K8, KI=K8, KS=K8,
                   KB=K8, KP=KP, KR=K8, max_slots=K, use_priority=False)
    return leaves, p, statics


def _card_case(name):
    """(leaves, packet, statics, the kernel's full-length word) of one of
    CARD_CASES."""
    if name in ("tenancy", "spec"):
        # imported here: both modules import this one
        if name == "tenancy":
            from test_torch_fused_tenancy import _tenancy_case

            return (*_tenancy_case(0, False, "auction"), 0)
        from test_torch_fused_spec import _spec_case

        return (*_spec_case(1, False, False), 0)
    if name == "spill":
        # cold prices kept (no refresh): the budget of 64 rounds runs out
        return (*_saturated(1, 4096, 1024, 8, 400, False), 0)
    if name == "cell":
        return (*_saturated(2, 200_000, 16_384, 8, 340, False,
                            price_hi=0.5, KP=2048), 0)
    refresh = name.startswith("cold") or name in ("n_match_0", "all_free")
    leaves, packet, statics = _case(30 + CARD_CASES.index(name),
                                    name.endswith("prio"), refresh)
    if name in ("cold_fcfs", "cold_prio", "warm_fcfs", "warm_prio"):
        return leaves, packet, statics, 0
    packet = _quiet(packet)
    now, K = float(packet[0]), statics["max_slots"]
    valid = leaves["valid"]
    live = np.flatnonzero(leaves["active"]
                          & (now - leaves["last_hb"] <= packet[8]))
    if name == "n_match_0":
        valid[:] = False
    elif name == "n_match_1":
        valid[:] = False
        valid[7] = True
        leaves["free"][live] = 2
    elif name == "all_free":
        valid[:] = True  # T >= S: every slot kept
        leaves["active"][:] = True
        leaves["last_hb"][:] = now
        leaves["free"][:] = K
    elif name in ("inf_speed", "nan_speed"):
        w = live[0]
        leaves["free"][w] = 2
        leaves["speed"][w] = -np.inf if name == "inf_speed" else np.nan
    elif name == "nan_size":
        leaves["free"][live] = 2
        leaves["sizes"][np.flatnonzero(valid)[0]] = np.nan
    elif name == "nan_price":
        # two free slots a live row, fewer than the valid tasks: every free
        # slot is kept; NaN and +inf carried prices on kept slots, and a
        # NaN on a slot past its row's free count
        leaves["free"][live] = 2
        leaves["price"][live[0] * K] = np.nan
        leaves["price"][live[1] * K + 1] = np.inf
        leaves["price"][live[2] * K + 3] = np.nan
    return leaves, packet, statics, int(name in HOSTILE)


HOSTILE = ("inf_speed", "nan_speed", "nan_size")
CARD_CASES = ["n_match_0", "n_match_1", "all_free", "cold_fcfs", "cold_prio",
              "warm_fcfs", "warm_prio", "spill", "cell", *HOSTILE, "tenancy",
              "spec", "nan_price"]


def _same(a, b) -> bool:
    """Bit for bit, a NaN equal to a NaN in the same place; None to None."""
    if a is None or b is None:
        return a is None and b is None
    if torch.equal(a, b):
        return True
    if not a.is_floating_point() or a.shape != b.shape:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_compacted_auction_matches_plain_on_card(case):
    """B1's auction over compacted lists against its plain version on the
    card, every output and state leaf (the carried prices included) bit
    for bit: no match, one (the 1 + eps increment), every slot free, cold
    and warm, FCFS and priority, a tick out of rounds that spills, the
    benchmark cell's shape, the tenancy and speculation lanes, NaN and
    +inf carried prices on kept slots (JAX's NaN rule in every bid); and the
    ticks with a -inf or NaN speed on a free slot or a NaN size on an
    admitted task, which take the full-length path and say so in the
    fourth aux word."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    leaves, packet, statics, full = _card_case(case)
    pkt = torch.from_numpy(packet).cuda()
    want, wst = tres._resident_tick_impl(
        pkt, tres.state_from_numpy(leaves, "cuda"), placement="auction",
        **statics)
    got, gst = fused_tick.fused_resident_tick(
        pkt, tres.state_from_numpy(leaves, "cuda"), placement="auction",
        **statics)
    assert want.auction_full_length is None
    assert int(got.auction_full_length) == full
    bad = [f for f, a, b in zip(got._fields, got, want, strict=True)
           if f != "auction_full_length" and not _same(a, b)]
    bad += [f"state.{f}" for f, a, b in zip(gst._fields, gst, wst,
                                            strict=True)
            if not _same(a, b)]
    assert not bad, bad
    rounds = int(got.auction_rounds)
    placed = int((got.placed_slots >= 0).sum())
    if case == "n_match_0":
        assert rounds == 0 and placed == 0
    elif case == "n_match_1":
        assert rounds == 1 and placed == 1
    elif case == "all_free":
        S = statics["W"] * statics["max_slots"]
        assert placed == min(statics["KP"], S)
    elif case == "spill":
        assert rounds == tau.WARM_ROUNDS and int(got.auction_spilled) > 0
