"""The top-2 bid (kernel B2's plain version) in the PyTorch port against JAX.

The same seeded numpy inputs go to the port's ``bid_top2`` on the CPU (its
plain version, ``bid_top2_stream_impl``) and to JAX's ``bid_top2_xla``,
``bid_top2_stream_impl`` and ``bid_top2_pallas`` (the TPU kernel under the
Pallas interpreter). The jitter hash must match exactly. The values follow
the JAX suite's own contract (tests/test_sched_pallas.py): within 1e-5,
and the argmax equal wherever the top-2 gap exceeds 2e-5. The reason is
that XLA may contract a product into an add, which moves a value by an
ulp, while the port rounds each op on its own so that its kernel and its
plain version agree bit for bit on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_faas.sched import pallas_kernels as jpk
from tpu_faas_torch.sched import bid

ATOL = 1e-5
f32 = np.float32


def _inputs(rng, T, S, frac_valid=0.8):
    return (
        rng.uniform(0.1, 5.0, T).astype(f32),
        (1.0 / rng.uniform(0.5, 4.0, S)).astype(f32),
        (rng.random(S) < frac_valid).astype(f32),
        rng.uniform(0.0, 3.0, S).astype(f32),
    )


def _port(args, scale, **kw):
    out = bid.bid_top2(*(torch.from_numpy(a) for a in args), float(scale),
                       **kw)
    return [o.numpy() for o in out]


def _jax(fn, args, scale, **kw):
    out = fn(*(jnp.asarray(a) for a in args), jnp.float32(scale), **kw)
    return [np.asarray(o) for o in out]


def _assert_top2_equiv(want, got):
    (v1w, bw, v2w), (v1g, bg, v2g) = want, got
    assert bg.dtype == np.int32 and v1g.dtype == v2g.dtype == f32
    np.testing.assert_allclose(v1g, v1w, rtol=0, atol=ATOL)
    np.testing.assert_allclose(v2g, v2w, rtol=0, atol=ATOL)
    decisive = np.isfinite(v1w) & ((v1w - v2w) > 2 * ATOL)
    assert decisive.mean() > 0.5
    np.testing.assert_array_equal(bg[decisive], bw[decisive])


def test_hash_matches_jax_exactly():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 50_000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jpk._hash_u32(jnp.asarray(x)))
    got = bid._hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_cell_index_wraps_like_uint32():
    """``row * n_slots_total + col`` passes 2^32 and must wrap exactly as
    JAX's uint32 product does. Zero sizes and prices and a unit jitter
    leave the value equal to u itself, so the check is exact."""
    rows = np.arange(2**20 - 3, 2**20 + 5, dtype=np.int32)[:, None]
    cols = np.arange(0, 8192, 97, dtype=np.int32)[None, :]
    n_total = 12_289  # rows * n_total crosses 2^32 (and 2^33)
    zeros_t = np.zeros((len(rows), 1), f32)
    zeros_s = np.zeros((1, cols.shape[1]), f32)
    ones_s = np.ones((1, cols.shape[1]), f32)
    want = np.asarray(jpk._bid_block(
        jnp.asarray(zeros_t), jnp.asarray(zeros_s), jnp.asarray(zeros_s),
        jnp.asarray(ones_s), jnp.asarray(rows), jnp.asarray(cols),
        jnp.float32(1.0), n_total,
    ))
    got = bid._bid_block(
        torch.from_numpy(zeros_t), torch.from_numpy(zeros_s),
        torch.from_numpy(zeros_s), torch.from_numpy(ones_s),
        torch.from_numpy(rows.astype(np.int64)),
        torch.from_numpy(cols.astype(np.int64)), 1.0, n_total,
    ).numpy()
    assert (rows.astype(np.int64) * n_total).max() > 2**33
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,S", [
    (jpk.TILE_T, jpk.CHUNK_S),
    (2 * jpk.TILE_T, jpk.CHUNK_S),
    (jpk.TILE_T, 3 * jpk.CHUNK_S),  # cross-chunk merge
])
def test_bid_matches_jax_xla(T, S):
    args = _inputs(np.random.default_rng(0), T, S)
    scale = f32(2.5e-4)
    _assert_top2_equiv(_jax(jpk.bid_top2_xla, args, scale),
                       _port(args, scale))


def test_bid_matches_jax_pallas_interpreted():
    args = _inputs(np.random.default_rng(4), jpk.TILE_T, 2 * jpk.CHUNK_S)
    scale = f32(2.5e-4)
    _assert_top2_equiv(
        _jax(jpk.bid_top2_pallas, args, scale, interpret=True),
        _port(args, scale),
    )


@pytest.mark.parametrize("T,S,row_offset,n_total", [
    (300, 777, 0, None),  # ragged, no tiling constraint
    (1000, 3001, 0, None),
    (257, 1500, 2**20 + 5, 8192),  # a shard whose hash index passes 2^32
    (64, 5000, 123_456, 40_000),
])
def test_bid_matches_jax_stream(T, S, row_offset, n_total):
    args = _inputs(np.random.default_rng(T + S), T, S, frac_valid=0.6)
    scale = f32(1e-4)
    kw = dict(row_offset=row_offset, n_slots_total=n_total)
    _assert_top2_equiv(_jax(jpk.bid_top2_stream_impl, args, scale, **kw),
                       _port(args, scale, **kw))


def test_plain_version_does_not_depend_on_its_tile(monkeypatch):
    """The tile-by-tile merge gives the same bits for any tile shape."""
    args = _inputs(np.random.default_rng(8), 333, 1111, frac_valid=0.5)
    whole = _port(args, f32(3e-4), row_offset=17)
    monkeypatch.setattr(bid, "_PLAIN_ROWS", 64)
    monkeypatch.setattr(bid, "_PLAIN_COLS", 100)
    tiled = _port(args, f32(3e-4), row_offset=17)
    for a, b in zip(whole, tiled):
        np.testing.assert_array_equal(a, b)


def test_cross_chunk_duplicate_max():
    """A max duplicated across chunks keeps the earlier index and reports
    v2 == v1 (only the argmax position is excluded)."""
    T, S = 256, 2 * jpk.CHUNK_S
    ts, inv = np.ones(T, f32), np.ones(S, f32)
    price = np.ones(S, f32)
    price[[37, jpk.CHUNK_S + 911]] = 0.0
    args = (ts, inv, np.ones(S, f32), price)
    want = _jax(jpk.bid_top2_xla, args, f32(0.0))
    got = _port(args, f32(0.0))
    assert (got[1] == 37).all() and (want[1] == 37).all()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], got[2])


def test_all_invalid_slots():
    ts, inv, _, price = _inputs(np.random.default_rng(1), 128, 700)
    args = (ts, inv, np.zeros(700, f32), price)
    want = _jax(jpk.bid_top2_xla, args, f32(1e-4))
    got = _port(args, f32(1e-4))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[0] == -np.inf).all() and (got[2] == -np.inf).all()
    assert (got[1] == 0).all()


def test_single_valid_slot():
    ts, inv, _, price = _inputs(np.random.default_rng(2), 128, 700)
    one = np.zeros(700, f32)
    one[137] = 1.0
    args = (ts, inv, one, price)
    want = _jax(jpk.bid_top2_xla, args, f32(1e-4))
    got = _port(args, f32(1e-4))
    assert (got[1] == 137).all() and (got[2] == -np.inf).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1])


def test_empty_shapes():
    got = _port((np.zeros(0, f32), np.ones(5, f32), np.ones(5, f32),
                 np.zeros(5, f32)), f32(1e-4))
    assert [g.shape for g in got] == [(0,), (0,), (0,)]
    got = _port((np.ones(3, f32),) + (np.zeros(0, f32),) * 3, f32(1e-4))
    assert (got[0] == -np.inf).all() and (got[1] == 0).all()


def test_wrapper_validates_kernel_inputs():
    """The CUDA wrapper checks device, dtype, shape and contiguity before
    it builds or launches anything; other devices raise."""
    args = [torch.from_numpy(a)
            for a in _inputs(np.random.default_rng(3), 32, 64)]
    with pytest.raises(ValueError, match="price"):
        bid.KERNEL(*args[:3], args[3].double(), 1e-4)
    with pytest.raises(ValueError, match="slot_valid"):
        bid.KERNEL(args[0], args[1], args[2][:-1], args[3], 1e-4)
    with pytest.raises(ValueError, match="task_size"):
        bid.KERNEL(torch.zeros(64, dtype=torch.float32)[::2], *args[1:],
                   1e-4)
    with pytest.raises(ValueError, match="no top-2 bid for device"):
        bid.bid_top2(*(a.to("meta") for a in args), 1e-4)
    assert bid.KERNEL.launches == 0


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Kernel B2 against its plain version on the card: exactly equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    for T, S, off, n_total in ((1000, 3001, 0, None),
                               (257, 1500, 2**20 + 5, 8192)):
        args = [torch.from_numpy(a).cuda() for a in
                _inputs(np.random.default_rng(T), T, S, frac_valid=0.6)]
        got = bid.bid_top2(*args, 1e-4, off, n_total)
        want = bid.bid_top2_stream_impl(*args, 1e-4, off, n_total)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
