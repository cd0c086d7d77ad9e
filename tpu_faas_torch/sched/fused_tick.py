"""The resident tick as ONE hand-written CUDA kernel, and its wrapper.

Counterpart of ``tpu_faas/sched/pallas_fused.py``: the TPU kernel
``_fused_resident_tick_impl`` runs the whole resident tick as one
``pl.pallas_call``; here ``csrc/fused_tick.cu`` does the same for Hopper —
apply the delta packet, liveness, purge, redispatch, rank placement and
output compaction in one launch, with the state tensors updated in place
(the counterpart of the Pallas kernel's ``input_output_aliases``: their
``data_ptr()`` never changes across ticks).

:func:`fused_resident_tick` is the entry. On CPU tensors it runs the plain
PyTorch version, ``resident._resident_tick_impl`` (the CPU has no kernel);
on CUDA tensors it launches the kernel or raises — there is no fallback.
The kernel launches on the current stream, does not synchronise and
allocates nothing: the wrapper allocates scratch once per shape and the
outputs fresh every tick, so a tick issued before the previous one is read
back never overwrites that one's outputs.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_faas_torch.build import build, check_arg
from tpu_faas_torch.sched.resident import (
    _HEADER,
    _KG,
    ResidentTickOutput,
    _flush_kernel_impl,
    _resident_tick_impl,
    _ResidentState,
)
from tpu_faas_torch.sched.state import unported

SOURCE = "tpu_faas_torch/csrc/fused_tick.cu"
REPLACES = "tpu_faas/sched/pallas_fused.py:147 (_fused_resident_tick_impl)"

_P = ctypes.c_void_p
_N_PTR = 13  # packet, 9 state leaves, out_i32, out_b8, scratch
_N_INT = 15  # T W I KA KH KF KI KS KB KP KR KG max_slots prio flush


class FusedTickKernel:
    """The built kernel, its per-shape scratch and its launch count."""

    name = "fused_tick"

    def __init__(self) -> None:
        #: kernel launches so far; callers may reset it to 0
        self.launches = 0
        self.ptxas_report = ""
        self._fn = None
        self._scratch: dict[tuple, torch.Tensor] = {}

    def load(self) -> None:
        """Build (if needed) and load the library; idempotent."""
        if self._fn is not None:
            return
        path, report = build(self.name)
        self.ptxas_report = report
        fn = ctypes.CDLL(str(path)).tpu_faas_fused_resident_tick
        fn.argtypes = [_P] * _N_PTR + [ctypes.c_int] * _N_INT + [_P]  # stream
        fn.restype = ctypes.c_int
        self._fn = fn

    def _scratch_for(self, dev: torch.device, T: int, S: int) -> torch.Tensor:
        # one buffer per (device, shape); launches on one stream run in
        # order, so reusing it across ticks is safe
        key = (dev, T, S)
        buf = self._scratch.get(key)
        if buf is None:
            buf = torch.empty(4 * S + 6 * T, dtype=torch.int32, device=dev)
            self._scratch[key] = buf
        return buf

    def __call__(self, packet, st, *, T, W, I, KA, KH, KF, KI, KS, KB, KP,
                 KR, max_slots, use_priority, flush):
        dev = packet.device
        P = (_HEADER + KA * (2 if use_priority else 1)
             + 2 * (KH + KF + KI + KS + KB))
        check_arg(packet, "packet", torch.float32, P, dev)
        for name, dtype, n in (
            ("sizes", torch.float32, T), ("valid", torch.bool, T),
            ("prio", torch.int32, T), ("last_hb", torch.float32, W),
            ("free", torch.int32, W), ("inflight", torch.int32, I),
            ("prev_live", torch.bool, W), ("speed", torch.float32, W),
            ("active", torch.bool, W),
        ):
            check_arg(getattr(st, name), name, dtype, n, dev)
        self.load()
        out_i32 = torch.empty(2 * KP + KA + KR + 1 + _KG, dtype=torch.int32,
                              device=dev)
        out_b8 = torch.empty(2 * W, dtype=torch.bool, device=dev)
        scratch = self._scratch_for(dev, T, W * max_slots)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = self._fn(
                packet.data_ptr(), st.sizes.data_ptr(), st.valid.data_ptr(),
                st.prio.data_ptr(), st.last_hb.data_ptr(),
                st.free.data_ptr(), st.inflight.data_ptr(),
                st.prev_live.data_ptr(), st.speed.data_ptr(),
                st.active.data_ptr(), out_i32.data_ptr(), out_b8.data_ptr(),
                scratch.data_ptr(),
                T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, _KG, max_slots,
                int(bool(use_priority)), int(bool(flush)), stream,
            )
        if err != 0:
            raise RuntimeError(f"fused_tick launch failed: CUDA error {err}")
        self.launches += 1
        o = 2 * KP
        arrival_slots = out_i32[o : o + KA]
        if flush:
            return st, arrival_slots
        res = ResidentTickOutput(
            placed_slots=out_i32[:KP],
            placed_rows=out_i32[KP : 2 * KP],
            arrival_slots=arrival_slots,
            redispatch_slots=out_i32[o + KA : o + KA + KR],
            purged=out_b8[:W],
            live=out_b8[W:],
            n_pending=out_i32[o + KA + KR],
            straggler_slots=out_i32[o + KA + KR + 1 :],
        )
        return res, st


#: the process's one instance: its ``launches`` is the kernel's count
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
    new state and leaves ``st`` untouched. The kernel places by rank; the
    auction runs on the CPU only (ROADMAP B1)."""
    if packet.device.type == "cuda":
        if placement != "rank":
            raise unported("the resident auction on CUDA")
        return KERNEL(packet, st, flush=flush, **statics)
    if packet.device.type != "cpu":
        raise ValueError(f"no fused tick for device {packet.device}")
    if flush:
        statics = {k: v for k, v in statics.items()
                   if k not in ("KP", "KR", "max_slots")}
        return _flush_kernel_impl(packet, st, **statics)
    return _resident_tick_impl(packet, st, placement=placement, **statics)
