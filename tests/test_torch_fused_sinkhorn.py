"""The resident Sinkhorn tick of the PyTorch port against the TPU kernel.

The JAX side is the fused Pallas resident tick (kernel B1) with
``placement="sinkhorn"``, run the way the JAX suite runs it on the CPU:
under the Pallas interpreter; at the bucketed shape (8,192 x 2,049, just
over the T*W > 2^24 route threshold) it is JAX's jitted
``_resident_tick``, the same trace. The port side is
``fused_tick.fused_resident_tick`` on CPU tensors, which runs the plain
version of the port's CUDA Sinkhorn branch.

Contract: the tick's outputs and state leaves are held as the solver's
(tests/test_torch_sinkhorn.py): exactly equal wherever that holds, which is
every seeded case here, hostile packets, dead fleets and empty queues
included. The potentials the port returns (``sinkhorn_f``/``sinkhorn_g``,
which JAX's tick does not return) are checked for their shape and for
replaying the same tick exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fused_auction import _SCRIPT, _Clock, _case, _drive
from tpu_faas.sched import pallas_fused as jfused
from tpu_faas.sched import resident as jres
from tpu_faas_torch.sched import fused_tick
from tpu_faas_torch.sched import resident as tres
from tpu_faas_torch.sched.state import sinkhorn_bucketed

f32, i32 = np.float32, np.int32


def _port_tick(leaves, packet, statics, **kw):
    return fused_tick.fused_resident_tick(
        torch.from_numpy(packet), tres.state_from_numpy(leaves, "cpu"),
        placement="sinkhorn", **statics, **kw,
    )


def _assert_tick_matches(want, wst, got, gst):
    for field in want._fields:
        np.testing.assert_array_equal(tres.to_host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    g = tres.state_to_numpy(gst)
    for field in wst._fields:
        np.testing.assert_array_equal(g[field], np.asarray(getattr(wst, field)),
                                      err_msg=field)


def _fused_both(leaves, packet, statics):
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    want, wst = jfused.fused_resident_tick(
        jnp.asarray(packet), jst, interpret=True, placement="sinkhorn",
        **statics,
    )
    got, gst = _port_tick(leaves, packet, statics)
    return want, wst, got, gst


@pytest.mark.parametrize("hostile", [False, True], ids=["plain", "hostile"])
@pytest.mark.parametrize("use_priority", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_tick_matches_fused_kernel(seed, use_priority, hostile):
    """One resident Sinkhorn tick from a random state (the dense route, 60
    iterations on [T+1, W+1]): the port's tick against the TPU kernel under
    the Pallas interpreter, priority lanes on and off."""
    leaves, packet, statics = _case(seed, use_priority, True,
                                    hostile=hostile)
    want, wst, got, gst = _fused_both(leaves, packet, statics)
    assert (np.asarray(want.placed_slots) >= 0).any()
    _assert_tick_matches(want, wst, got, gst)
    T, W = statics["T"], statics["W"]
    assert got.sinkhorn_f.shape == (T + 1,)
    assert got.sinkhorn_g.shape == (W + 1,)
    # the tick from its own potentials is the same tick
    again, ast = _port_tick(leaves, packet, statics, sinkhorn_potentials=(
        got.sinkhorn_f, got.sinkhorn_g))
    for a, b in zip((*again, *ast), (*got, *gst)):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_ticks_in_sequence_match_fused_kernel(seed):
    """Three ticks in a row, each from the state JAX's last tick left."""
    leaves, packet, statics = _case(30 + seed, False, True)
    for _ in range(3):
        want, wst, got, gst = _fused_both(leaves, packet, statics)
        _assert_tick_matches(want, wst, got, gst)
        leaves = {f: np.array(getattr(wst, f)) for f in wst._fields}
        leaves["free"] = np.maximum(leaves["free"], 2).astype(i32)


@pytest.mark.parametrize("case", ["dead-fleet", "no-valid-task",
                                  "one-speed"])
def test_sinkhorn_edge_ticks_match_fused_kernel(case):
    """A fleet with no live worker, a queue with no valid task and no
    arrival, and every worker at one speed (identical columns, so every
    argmax is a tie that falls to the first index)."""
    leaves, packet, statics = _case(11, False, True)
    if case == "dead-fleet":
        leaves["active"][:] = False
        packet[6] = 0  # no active-flag deltas
    elif case == "no-valid-task":
        leaves["valid"][:] = False
        packet[1] = 0  # no arrivals
    else:
        leaves["speed"][:] = 2.0
        packet[5] = 0  # no speed deltas
        leaves["free"][:] = 3
    want, wst, got, gst = _fused_both(leaves, packet, statics)
    _assert_tick_matches(want, wst, got, gst)
    placed = int((np.asarray(want.placed_slots) >= 0).sum())
    assert (placed == 0) == (case != "one-speed")


def _bucketed_case(seed, use_priority):
    """A resident state at 8,192 pending x 2,049 workers (T*W just over
    2^24: the bucketed route) and one packet, sizes lognormal."""
    T, W, I = 8192, 2049, 256
    rng = np.random.default_rng(seed)
    now = 40.0
    leaves = dict(
        sizes=rng.lognormal(0.0, 1.0, T).astype(f32),
        valid=rng.random(T) < 0.7,
        prio=rng.integers(-2, 3, T).astype(i32),
        tenant=np.zeros(T, i32),
        last_hb=(now - rng.uniform(0.0, 12.0, W)).astype(f32),
        free=rng.integers(-1, 6, W).astype(i32),
        inflight=np.where(rng.random(I) < 0.5, -1,
                          rng.integers(0, W, I)).astype(i32),
        prev_live=rng.random(W) < 0.9,
        speed=rng.uniform(0.5, 4.0, W).astype(f32),
        active=rng.random(W) < 0.95,
        price=np.zeros(W * 4, f32),
        t_deficit=np.zeros(1, f32),
        infl_start=np.zeros(1, f32),
        infl_pred=np.zeros(1, f32),
        avoid=np.full(1, -1, i32),
        refresh=np.asarray(True),
    )
    KA, KH = 64, 64
    lanes = 2 if use_priority else 1
    packet = np.zeros(9 + KA * lanes + 2 * (KH + 4 * 16), f32)
    packet[0], packet[1], packet[2], packet[8] = now, KA, KH, 10.0
    packet[9 : 9 + KA] = rng.lognormal(0.0, 1.0, KA)
    off = 9 + KA * lanes
    if use_priority:
        packet[9 + KA : off] = rng.integers(-2, 3, KA)
    packet[off : off + KH] = rng.choice(W, KH, replace=False)
    packet[off + KH : off + 2 * KH] = now - rng.uniform(0.0, 3.0, KH)
    statics = dict(T=T, W=W, I=I, KA=KA, KH=KH, KF=16, KI=16, KS=16, KB=16,
                   KP=1024, KR=32, max_slots=4, use_priority=use_priority)
    return leaves, packet, statics


@pytest.mark.parametrize("use_priority", [False, True])
def test_bucketed_tick_matches_jax_resident_tick(use_priority):
    """The bucketed route (20 iterations on [1,025, 2,050], bucket
    rounding) against JAX's resident tick at the JAX suite's bucketed
    shape."""
    leaves, packet, statics = _bucketed_case(3, use_priority)
    assert sinkhorn_bucketed(statics["T"], statics["W"])
    jst = jres._ResidentState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    want, wst = jres._resident_tick(jnp.asarray(packet), jst,
                                    placement="sinkhorn", **statics)
    got, gst = _port_tick(leaves, packet, statics)
    assert int((np.asarray(want.placed_slots) >= 0).sum()) == statics["KP"]
    _assert_tick_matches(want, wst, got, gst)
    assert got.sinkhorn_f.shape == (1025,)


def test_scripted_history_matches_fused_kernel():
    """The scripted history — arrivals, results, heartbeat churn, a purge
    and reconnect — resolves identically through the port's resident
    Sinkhorn and JAX's interpreted fused tick, and leaves the same state."""
    small = dict(max_workers=32, max_pending=64, max_inflight=128,
                 max_slots=4, KA=8, KP=16, KR=8, placement="sinkhorn")
    a = jres.ResidentScheduler(clock=_Clock(), tick_backend="fused_interpret",
                               **small)
    b = tres.ResidentScheduler(clock=_Clock(), device="cpu", **small)
    va, vb = _drive(a, _SCRIPT), _drive(b, _SCRIPT)
    assert va == vb
    assert any(p for p, *_ in va) and any(rd for _, rd, *_ in va)
    w, g = a._r_state, tres.state_to_numpy(b._r_state)
    for field in w._fields:
        np.testing.assert_array_equal(g[field], np.asarray(getattr(w, field)),
                                      err_msg=field)


def test_sinkhorn_route_is_static_on_t_times_w():
    assert sinkhorn_bucketed(51_200, 4_096)  # the headline
    assert sinkhorn_bucketed(8_192, 2_049)
    assert not sinkhorn_bucketed(8_192, 2_048)  # exactly 2^24: dense
    assert not sinkhorn_bucketed(4_096, 4_096)


def test_resident_sinkhorn_on_cuda_needs_a_card():
    """A CUDA resident Sinkhorn is ported: without a GPU it raises the
    device module's no-CUDA error, not NotImplementedError."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the scheduler builds")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tres.ResidentScheduler(max_workers=16, max_pending=64,
                               placement="sinkhorn", device="cuda")


def test_sinkhorn_wrapper_validates_before_building():
    """The CUDA Sinkhorn wrapper checks the packet and the leaves before it
    builds or launches anything."""
    leaves, packet, statics = _case(3, False, True)
    st = tres.state_from_numpy(leaves, "cpu")
    kernel = fused_tick.FusedTickKernel()
    with pytest.raises(ValueError, match="packet"):
        kernel.sinkhorn(torch.from_numpy(packet[:-1]), st, **statics)
    with pytest.raises(ValueError, match="speed"):
        kernel.sinkhorn(torch.from_numpy(packet),
                        st._replace(speed=st.speed.double()), **statics)
    assert kernel.sinkhorn_launches == 0 and kernel._fn is None


@pytest.mark.cuda
def test_sinkhorn_kernel_matches_plain_on_card():
    """The CUDA Sinkhorn branch against its plain version on the card, on
    the dense route and the bucketed one: every output and state leaf that
    placement does not decide exactly equal, the potentials within 1e-4 of
    tau, and the plain rounding from the kernel's own potentials equal to
    the kernel's tick on everything."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    for leaves, packet, statics in (_case(5, True, True, hostile=True),
                                    _bucketed_case(3, False)):
        pkt = torch.from_numpy(packet).cuda()
        got, gst = fused_tick.fused_resident_tick(
            pkt, tres.state_from_numpy(leaves, "cuda"), placement="sinkhorn",
            **statics)
        want, wst = tres._resident_tick_impl(
            pkt, tres.state_from_numpy(leaves, "cuda"), placement="sinkhorn",
            **statics)
        for f in ("arrival_slots", "redispatch_slots", "purged", "live",
                  "n_pending", "sinkhorn_tau"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        for f in gst._fields:
            if f not in ("valid", "free"):
                assert torch.equal(getattr(gst, f), getattr(wst, f)), f
        tau = float(got.sinkhorn_tau)
        for a, b in ((got.sinkhorn_f, want.sinkhorn_f),
                     (got.sinkhorn_g, want.sinkhorn_g)):
            fin = torch.isfinite(b)
            assert torch.equal(torch.isfinite(a), fin)
            assert float((a[fin] - b[fin]).abs().max()) / tau <= 1e-4
        rep, rst = tres._resident_tick_impl(
            pkt, tres.state_from_numpy(leaves, "cuda"), placement="sinkhorn",
            sinkhorn_potentials=(got.sinkhorn_f, got.sinkhorn_g), **statics)
        for a, b in zip(got, rep):
            assert (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(gst, rst):
            assert torch.equal(a, b)
