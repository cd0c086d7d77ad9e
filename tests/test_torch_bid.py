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

import zlib

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
    """The tile-by-tile merge gives the same bits for any tile shape, with
    NaN cells (C.3's inputs) too."""
    cases = [(_inputs(np.random.default_rng(8), 333, 1111, frac_valid=0.5),
              f32(3e-4))]
    cases += [_nan_case(kind, 333, 1111) for kind in NAN_KINDS]
    whole = [_port(args, scale, row_offset=17) for args, scale in cases]
    monkeypatch.setattr(bid, "_PLAIN_ROWS", 64)
    monkeypatch.setattr(bid, "_PLAIN_COLS", 100)
    for (args, scale), w in zip(cases, whole):
        tiled = _port(args, scale, row_offset=17)
        for a, b in zip(w, tiled):
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


def _split_case(kind, S, edge):
    """Inputs for the chunk-merge cases: 64 rows over S slots."""
    # a seed that does not change with the process's string hashing
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    ts, inv, valid, price = _inputs(rng, 64, S)
    scale = f32(2.5e-4)
    if kind == "duplicate max at a chunk edge":
        # zero jitter keeps the tie: slots edge-1 and edge share the max
        ts, inv, valid = np.ones(64, f32), np.ones(S, f32), np.ones(S, f32)
        price = np.ones(S, f32)
        price[[edge - 1, edge]] = 0.0
        scale = f32(0.0)
    elif kind == "all slots invalid":
        valid = np.zeros(S, f32)
    elif kind == "one valid slot":
        valid = np.zeros(S, f32)
        valid[S // 2 + 3] = 1.0
    elif kind == "signed zero sizes":
        ts[::2], ts[1::4] = 0.0, -0.0
    elif kind == "NaN sizes":
        ts[::5] = np.nan
    return (ts, inv, valid, price), scale


@pytest.mark.parametrize("kind", [
    "random", "duplicate max at a chunk edge", "all slots invalid",
    "one valid slot", "signed zero sizes", "NaN sizes",
])
@pytest.mark.parametrize("C", [1, 2, 3, 7, 128])
def test_chunk_merge_matches_jax_in_any_order(kind, C):
    """The auction branch splits a round's slots into C chunks, sweeps each
    in its own warp and merges the chunks' top-2s with the kernel's merge
    (``bid.merge_top2``). Here the plain top-2 of each chunk (its last
    chunk ragged), merged in shuffled orders, must equal JAX's
    ``bid_top2_xla`` over all the slots exactly. A NaN size makes every
    valid cell of its row NaN: the kernel's sweep takes JAX's NaN rule on
    such a row, so the merged result is JAX's own (v1 = NaN at the first
    valid slot, v2 = NaN) in every order. Neither bids (the auction bids
    only on a finite v1)."""
    S = 4201  # every C gives C chunks, the last ragged
    L = -(-S // C)
    edge = L if C > 1 else S // 2
    (ts, inv, valid, price), scale = _split_case(kind, S, edge)
    want = _jax(jpk.bid_top2_xla, (ts, inv, valid, price), scale)
    parts = _chunk_parts((ts, inv, valid, price), scale, L)
    assert len(parts) == C
    nan_rows = np.isnan(ts)
    rng = np.random.default_rng(C)
    for _ in range(4):
        got = _merged(parts, rng.permutation(len(parts)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    if kind == "NaN sizes":
        assert np.isnan(got[0][nan_rows]).all()
        assert np.isnan(got[2][nan_rows]).all()
        assert (got[1][nan_rows] == np.flatnonzero(valid)[0]).all()
    if kind == "duplicate max at a chunk edge":
        assert (got[1] == edge - 1).all() and np.array_equal(got[0], got[2])


def _chunk_parts(args, scale, L):
    """The plain top-2 of each slot chunk of length L (the last ragged) of
    the 1-D inputs ``args`` = (size, inv_speed, valid, price)."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    T, S = t[0].shape[0], t[1].shape[0]
    rows = torch.arange(T, dtype=torch.int64)[:, None]
    parts = []
    for lo in range(0, S, L):
        hi = min(lo + L, S)
        val = bid._bid_block(t[0][:, None], t[1][None, lo:hi],
                             t[3][None, lo:hi], t[2][None, lo:hi], rows,
                             torch.arange(lo, hi)[None], float(scale), S)
        parts.append(bid._top2_block(val, lo))
    return parts


def _merged(parts, order):
    """``parts`` merged with ``bid.merge_top2`` in ``order``, from the
    empty top-2."""
    T = parts[0][0].shape[0]
    acc = (torch.full((T,), float("-inf")), torch.zeros(T, dtype=torch.int32),
           torch.full((T,), float("-inf")))
    for k in order:
        acc = bid.merge_top2(acc, parts[k])
    return [a.numpy() for a in acc]


def _nan_case(kind, T=96, S=1500):
    """C.3's inputs: a NaN size, a NaN speed on one valid slot, a NaN price
    on one, a NaN jitter, and an infinite size beside an infinite price
    (inf - inf); each with slots valid or not around it."""
    rng = np.random.default_rng(len(kind))
    ts, inv, valid, price = _inputs(rng, T, S, frac_valid=0.7)
    scale = f32(2.5e-4)
    slot = 977  # past the port's small test tiles and the chunks' edges
    valid[slot] = 1.0
    if kind == "NaN size":
        ts[[3, 40, 41]] = np.nan
    elif kind == "NaN speed on one valid slot":
        inv[slot] = np.nan
    elif kind == "NaN price":
        price[slot] = np.nan
        price[slot + 1] = np.nan  # a second NaN cell: v2 is NaN too
        valid[slot + 1] = 1.0
    elif kind == "NaN jitter":
        scale = f32(np.nan)
    elif kind == "inf size and price":
        ts[5] = -np.inf  # +inf products
        price[slot] = np.inf
    elif kind == "NaN on an invalid slot":
        inv[slot], valid[slot] = np.nan, 0.0
    return (ts, inv, valid, price), scale


NAN_KINDS = ["NaN size", "NaN speed on one valid slot", "NaN price",
             "NaN jitter", "inf size and price", "NaN on an invalid slot"]


@pytest.mark.parametrize("kind", NAN_KINDS)
def test_nan_cells_match_jax_xla(kind, monkeypatch):
    """C.3: on NaN inputs the port's plain version, at its own tile and at
    small tiles (so a NaN meets a number at a tile edge), equals JAX's
    ``bid_top2_xla`` exactly: the first NaN is the maximum, v2 excludes only
    the argmax position and propagates any other NaN. ``merge_top2`` over
    the chunks' top-2s in shuffled orders gives the same."""
    args, scale = _nan_case(kind)
    want = _jax(jpk.bid_top2_xla, args, scale)
    if kind != "NaN on an invalid slot":
        assert np.isnan(want[0]).any()
    for g, w in zip(_port(args, scale), want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(bid, "_PLAIN_ROWS", 32)
    monkeypatch.setattr(bid, "_PLAIN_COLS", 128)
    for g, w in zip(_port(args, scale), want):
        np.testing.assert_array_equal(g, w)
    parts = _chunk_parts(args, scale, 128)
    rng = np.random.default_rng(5)
    for _ in range(3):
        for g, w in zip(_merged(parts, rng.permutation(len(parts))), want):
            np.testing.assert_array_equal(g, w)


def test_nan_smallest_input_matches_jax():
    """ROADMAP C.3's smallest input: one task whose size is NaN and one
    valid slot. JAX's ``bid_top2_xla`` gives v1 = NaN at that slot and
    v2 = -inf (every other cell is invalid); so do the port's plain
    version and the merge of the slots' chunks, in every order (the kernel
    once gave (-inf, 0, -inf))."""
    ts = np.array([np.nan, 1.5], f32)
    inv, price = np.ones(8, f32), np.zeros(8, f32)
    valid = np.zeros(8, f32)
    valid[5] = 1.0
    args = (ts, inv, valid, price)
    want = _jax(jpk.bid_top2_xla, args, f32(1e-4))
    got = _port(args, f32(1e-4))
    assert np.isnan(got[0][0]) and got[1][0] == 5 and got[2][0] == -np.inf
    parts = _chunk_parts(args, f32(1e-4), 3)
    for order in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        for g, w, m in zip(got, want, _merged(parts, order)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(m, w)


@pytest.mark.parametrize("route", ["pallas", "stream"])
def test_jax_chunked_routes_keep_a_number_over_a_later_nan(route):
    """JAX's own chunked routes disagree with ``bid_top2_xla`` when a NaN
    cell lies in a later slot chunk than a number: their fold
    (``pallas_kernels.py:181-185``, and the stream impl's) takes a chunk only
    on a strict ``>``, so the earlier chunk's number stays v1 with its slot,
    and ``jnp.minimum`` of it and the NaN makes v2 NaN; ``bid_top2_xla``
    takes the NaN as v1 at its slot and the number as v2. The port follows
    ``bid_top2_xla`` whatever its tile (C.3)."""
    T, S = jpk.TILE_T, 2 * jpk.CHUNK_S
    ts, inv, valid, price = _inputs(np.random.default_rng(6), T, S, 1.0)
    nan_slot = jpk.CHUNK_S + 17
    price[nan_slot] = np.nan
    scale = f32(2.5e-4)
    args = (ts, inv, valid, price)
    want = _jax(jpk.bid_top2_xla, args, scale)
    if route == "pallas":
        chunked = _jax(jpk.bid_top2_pallas, args, scale, interpret=True)
    else:
        chunked = _jax(jpk.bid_top2_stream_impl, args, scale)
    port = _port(args, scale)
    assert np.isnan(want[0]).all() and (want[1] == nan_slot).all()
    assert np.isfinite(want[2]).all()
    assert np.isfinite(chunked[0]).all() and (chunked[1] < jpk.CHUNK_S).all()
    assert np.isnan(chunked[2]).all()
    # the number kept is the first chunk's maximum
    (first,) = _chunk_parts(args, scale, jpk.CHUNK_S)[:1]
    np.testing.assert_allclose(chunked[0], first[0].numpy(), rtol=0,
                               atol=ATOL)
    for g, w in zip(port, want):
        np.testing.assert_array_equal(g, w)


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
