"""The auction's hot op: fused top-2 bidding, and kernel B2's wrapper.

Counterpart of ``tpu_faas/sched/pallas_kernels.py``. Each auction round
needs, per task row t, the best slot value, its first argmax slot and the
runner-up of

    v[t, s] = -size[t] * inv_speed[s] + u(t, s) * jitter_scale - price[s]

(−inf where ``valid[s] == 0``) over an implicit [T, S] matrix, which is never
built. ``u`` is a deterministic tie-breaking jitter: the Wang hash of the
uint32 cell index ``row * n_slots_total + col``, shifted right by 8 and
scaled by 2^-24.

:func:`bid_top2` is the entry. On CUDA tensors it launches the hand-written
kernel ``csrc/bid_top2.cu``; on CPU tensors it runs the plain version,
:func:`bid_top2_stream_impl`; any other device raises. There is no fallback
and no size cut-over: on the card the bid is always the kernel.

The plain version fixes the op order once — ``((-size) * inv_speed) + (u *
jitter_scale) - price``, each op rounded on its own — and the kernel does
the same with ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``, so the two agree
bit for bit on the card. Against JAX, whose compiler may contract a product
into an add, values agree within 1e-5 (the JAX suite's own contract). NaN
cells (a non-finite size, inverse speed, price or jitter) take JAX's
``bid_top2_xla`` rule in both: the first NaN is the maximum, and the
runner-up propagates a NaN.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_faas_torch.build import build, check_arg

SOURCE = "tpu_faas_torch/csrc/bid_top2.cu"
REPLACES = "tpu_faas/sched/pallas_kernels.py:189 (bid_top2_pallas)"

_I32 = torch.int32
_MASK32 = 0xFFFFFFFF
#: the plain version's tile: rows x slot columns per step (8 Mi cells, a
#: few hundred MB of int64/f32 intermediates at most)
_PLAIN_ROWS = 2048
_PLAIN_COLS = 4096


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Wang hash over uint32 values held in int64 (the CPU has no ``>>`` on
    torch uint32): every product is masked back to 32 bits, so the result
    equals uint32 arithmetic exactly."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _MASK32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _MASK32
    return x ^ (x >> 15)


def _bid_block(
    ts_col: torch.Tensor,  # f32[m,1] task sizes
    inv_row: torch.Tensor,  # f32[1,n] 1/speed per slot
    price_row: torch.Tensor,  # f32[1,n]
    valid_row: torch.Tensor,  # f32[1,n] 1.0 = slot usable
    rows: torch.Tensor,  # int64[m,1] global row ids
    cols: torch.Tensor,  # int64[1,n] global col ids
    jitter_scale: float,  # an f32 value
    n_slots_total: int,
) -> torch.Tensor:
    """The elementwise bid-value formula, in the op order the kernel uses."""
    # row * n_slots_total + col wraps mod 2^32, as uint32 does
    idx = ((rows & _MASK32) * (n_slots_total & _MASK32) + cols) & _MASK32
    # a 24-bit integer: exact in f32, and exact again after the 2^-24 scale
    u = (_hash_u32(idx) >> 8).to(_I32).to(torch.float32) * 2.0**-24
    val = ((-ts_col) * inv_row + u * jitter_scale) - price_row
    return torch.where(valid_row > 0, val, float("-inf"))


def _top2_block(val: torch.Tensor, col_offset: int):
    """Per-row (max, first argmax + ``col_offset``, runner-up) of a [m, n]
    value block. The runner-up excludes only the argmax position, so a
    duplicated max gives ``v2 == v1``."""
    best_local = val.argmax(dim=1, keepdim=True)
    v1 = val.gather(1, best_local)
    local = torch.arange(val.shape[1], device=val.device)[None, :]
    v2 = torch.where(local == best_local, float("-inf"), val).amax(dim=1)
    return v1[:, 0], (best_local[:, 0] + col_offset).to(_I32), v2


def merge_top2(a, b):
    """The kernel's merge of two top-2 results over disjoint slot sets
    (``csrc/bid_top2.cuh::merge``), in torch: the larger ``v1`` wins, a NaN
    first (as JAX's argmax takes it), and a tie goes to the lower slot; the
    runner-up is the largest of both runner-ups and of the losing maximum,
    through ``fmax``/``fmin`` as the kernel's ``fmaxf``/``fminf``, and NaN
    when a runner-up is NaN or both maxima are. Exact in any order and
    grouping, so the auction branch may sweep a row's slots in chunks and
    merge the chunks' results. ``a`` and ``b`` are (v1, best, v2)."""
    (v1a, ba, v2a), (v1b, bb, v2b) = a, b
    na, nb = torch.isnan(v1a), torch.isnan(v1b)
    take = torch.where(nb, ~na | (bb < ba),
                       ~na & ((v1b > v1a) | ((v1b == v1a) & (bb < ba))))
    nan2 = torch.isnan(v2a) | torch.isnan(v2b) | (na & nb)
    v2 = torch.fmax(torch.fmax(v2a, v2b), torch.fmin(v1a, v1b))
    v2 = torch.where(nan2, float("nan"), v2)
    return torch.where(take, v1b, v1a), torch.where(take, bb, ba), v2


def bid_top2_stream_impl(
    task_size: torch.Tensor,  # f32[T]
    slot_inv_speed: torch.Tensor,  # f32[S]
    slot_valid: torch.Tensor,  # f32[S] 1.0 = usable
    price: torch.Tensor,  # f32[S]
    jitter_scale: float,  # an f32 value
    row_offset: int = 0,  # global id of row 0 (a task shard's base)
    n_slots_total: int | None = None,  # jitter-hash stride (default S)
):
    """The plain version: the top-2 bid tile by tile, any (T, S), never the
    [T, S] matrix. Slot chunks fold into a running per-row top-2 with the
    TPU kernel's merge: strict ``>`` keeps the earlier chunk on ties (the
    global first argmax), and the runner-up of the union is the max of both
    runner-ups and the losing max. A NaN cell follows ``bid_top2_xla``
    whatever the tile: the first NaN is the maximum and the runner-up
    propagates every other NaN (the TPU kernel's own fold keeps an earlier
    chunk's number over a later chunk's NaN). ``row_offset``/
    ``n_slots_total`` keep the hash global when only a shard of the rows is
    in hand."""
    T, S = task_size.shape[0], slot_inv_speed.shape[0]
    hash_S = S if n_slots_total is None else n_slots_total
    dev = task_size.device
    inf = float("-inf")
    v1 = torch.full((T,), inf, dtype=torch.float32, device=dev)
    best = torch.zeros(T, dtype=_I32, device=dev)
    v2 = torch.full((T,), inf, dtype=torch.float32, device=dev)
    for t0 in range(0, T, _PLAIN_ROWS):
        t1 = min(T, t0 + _PLAIN_ROWS)
        ts_col = task_size[t0:t1, None]
        rows = torch.arange(row_offset + t0, row_offset + t1,
                            dtype=torch.int64, device=dev)[:, None]
        a1, ab, a2 = v1[t0:t1], best[t0:t1], v2[t0:t1]
        for s0 in range(0, S, _PLAIN_COLS):
            s1 = min(S, s0 + _PLAIN_COLS)
            cols = torch.arange(s0, s1, dtype=torch.int64, device=dev)[None]
            val = _bid_block(
                ts_col, slot_inv_speed[None, s0:s1], price[None, s0:s1],
                slot_valid[None, s0:s1], rows, cols, jitter_scale, hash_S,
            )
            c1, cb, c2 = _top2_block(val, s0)
            # a later chunk's NaN maximum beats a number, as in JAX's
            # argmax over the whole row; between numbers a tie keeps the
            # earlier chunk
            n1, nc = torch.isnan(a1), torch.isnan(c1)
            take = (nc & ~n1) | (c1 > a1)
            # the union's runner-up: both runner-ups and the losing maximum,
            # which beside a NaN maximum is the other one
            lose = torch.where(n1 | nc, torch.where(n1, c1, a1),
                               torch.minimum(a1, c1))
            a2 = torch.maximum(torch.maximum(a2, c2), lose)
            a1 = torch.where(take, c1, a1)
            ab = torch.where(take, cb, ab)
        v1[t0:t1], best[t0:t1], v2[t0:t1] = a1, ab, a2
    return v1, best, v2


class BidTop2Kernel:
    """The built kernel B2 and its launch count."""

    name = "bid_top2"

    def __init__(self) -> None:
        #: kernel launches so far; callers may reset it to 0
        self.launches = 0
        self.ptxas_report = ""
        self._fn = None
        #: per device: the one int the NaN pre-pass writes (launches on one
        #: stream run in order, so it is reused)
        self._flag: dict[torch.device, torch.Tensor] = {}

    def load(self) -> None:
        """Build (if needed) and load the library; idempotent."""
        if self._fn is not None:
            return
        path, report = build(self.name)
        self.ptxas_report = report
        fn = ctypes.CDLL(str(path)).tpu_faas_bid_top2
        P = ctypes.c_void_p
        fn.argtypes = [P, P, P, P, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_uint, ctypes.c_uint, P, P, P, P, P]
        fn.restype = ctypes.c_int
        self._fn = fn

    def __call__(self, task_size, slot_inv_speed, slot_valid, price,
                 jitter_scale: float, row_offset: int = 0,
                 n_slots_total: int | None = None):
        dev = task_size.device
        T, S = task_size.shape[0], slot_inv_speed.shape[0]
        check_arg(task_size, "task_size", torch.float32, T, dev)
        for name, t in (("slot_inv_speed", slot_inv_speed),
                        ("slot_valid", slot_valid), ("price", price)):
            check_arg(t, name, torch.float32, S, dev)
        self.load()
        v1 = torch.empty(T, dtype=torch.float32, device=dev)
        best = torch.empty(T, dtype=_I32, device=dev)
        v2 = torch.empty(T, dtype=torch.float32, device=dev)
        hash_S = S if n_slots_total is None else n_slots_total
        flag = self._flag.get(dev)
        if flag is None:
            flag = self._flag[dev] = torch.empty(1, dtype=_I32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(
                task_size.data_ptr(), slot_inv_speed.data_ptr(),
                slot_valid.data_ptr(), price.data_ptr(), float(jitter_scale),
                T, S, row_offset & _MASK32, hash_S & _MASK32,
                flag.data_ptr(), v1.data_ptr(), best.data_ptr(),
                v2.data_ptr(), stream,
            )
        if err != 0:
            raise RuntimeError(f"bid_top2 launch failed: CUDA error {err}")
        self.launches += 1
        return v1, best, v2


#: the process's one instance: its ``launches`` is the kernel's count
KERNEL = BidTop2Kernel()


def bid_top2(
    task_size: torch.Tensor,
    slot_inv_speed: torch.Tensor,
    slot_valid: torch.Tensor,
    price: torch.Tensor,
    jitter_scale: float,
    row_offset: int = 0,
    n_slots_total: int | None = None,
):
    """Per task row: (best value f32[T], first argmax slot i32[T],
    runner-up f32[T]). The kernel on CUDA tensors, the plain version on CPU
    tensors. ``jitter_scale`` is a Python float holding an f32 value."""
    dev = task_size.device
    if dev.type == "cuda":
        return KERNEL(task_size, slot_inv_speed, slot_valid, price,
                      jitter_scale, row_offset, n_slots_total)
    if dev.type != "cpu":
        raise ValueError(f"no top-2 bid for device {dev}")
    return bid_top2_stream_impl(task_size, slot_inv_speed, slot_valid, price,
                                jitter_scale, row_offset, n_slots_total)
