"""Padded placement-problem construction.

Counterpart of ``tpu_faas/sched/problem.py``: the problem's vectors are
torch tensors on an explicit device (``"cuda"`` unless the caller asks for
the CPU), padded as JAX pads them. Everything the kernels consume has a
static shape: T task rows and W worker columns fixed at dispatcher start (bucketed growth re-compiles at most
log2(max/min) times). Validity is carried in masks, never in shape — worker
churn (register/purge/reconnect, reference task_dispatcher.py:347-367) is a
mask update, not a reshape, which is what keeps the hot tick recompile-free.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_faas_torch.device import resolve_device, upload


def pad_to(n: int, bucket: int) -> int:
    """Smallest multiple of ``bucket`` >= n (and >= bucket)."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


@dataclass
class PlacementProblem:
    """One tick's placement inputs, padded.

    task_size:     f32[T]  estimated execution cost per pending task
    task_valid:    bool[T] row is a real task
    worker_speed:  f32[W]  relative throughput of each worker (1.0 = nominal)
    worker_free:   i32[W]  free process slots right now
    worker_live:   bool[W] registered AND heartbeat-fresh
    """

    task_size: torch.Tensor
    task_valid: torch.Tensor
    worker_speed: torch.Tensor
    worker_free: torch.Tensor
    worker_live: torch.Tensor

    @property
    def T(self) -> int:
        return self.task_size.shape[0]

    @property
    def W(self) -> int:
        return self.worker_speed.shape[0]

    @classmethod
    def build(
        cls,
        task_sizes: "np.ndarray | list[float]",
        worker_speeds: "np.ndarray | list[float]",
        worker_free: "np.ndarray | list[int]",
        worker_live: "np.ndarray | list[bool] | None" = None,
        T: int | None = None,
        W: int | None = None,
        device: "str | torch.device" = "cuda",
    ) -> "PlacementProblem":
        """Pad host-side vectors into a problem on ``device``."""
        dev = resolve_device(device)
        task_sizes = np.asarray(task_sizes, dtype=np.float32)
        worker_speeds = np.asarray(worker_speeds, dtype=np.float32)
        worker_free = np.asarray(worker_free, dtype=np.int32)
        if worker_live is None:
            worker_live = np.ones(worker_speeds.shape[0], dtype=bool)
        else:
            worker_live = np.asarray(worker_live, dtype=bool)
        T = T or pad_to(len(task_sizes), 256)
        W = W or pad_to(len(worker_speeds), 256)
        ts = np.zeros(T, dtype=np.float32)
        ts[: len(task_sizes)] = task_sizes
        tv = np.zeros(T, dtype=bool)
        tv[: len(task_sizes)] = True
        ws = np.zeros(W, dtype=np.float32)
        ws[: len(worker_speeds)] = worker_speeds
        wf = np.zeros(W, dtype=np.int32)
        wf[: len(worker_free)] = worker_free
        wl = np.zeros(W, dtype=bool)
        wl[: len(worker_live)] = worker_live
        return cls(
            task_size=upload(ts, dev),
            task_valid=upload(tv, dev),
            worker_speed=upload(ws, dev),
            worker_free=upload(wf, dev),
            worker_live=upload(wl, dev),
        )


def check_assignment(
    assignment: np.ndarray,
    task_valid: np.ndarray,
    worker_free: np.ndarray,
    worker_live: np.ndarray,
) -> None:
    """Host-side invariant checks shared by tests: capacity respected, only
    live workers used, invalid tasks unassigned. Raises AssertionError."""
    assignment = np.asarray(assignment)
    assert assignment.shape == np.asarray(task_valid).shape
    assert (assignment[~np.asarray(task_valid)] == -1).all(), "padding rows assigned"
    used = assignment[assignment >= 0]
    if used.size:
        counts = np.bincount(used, minlength=len(worker_free))
        assert (counts <= np.asarray(worker_free)).all(), "capacity violated"
        assert np.asarray(worker_live)[used].all(), "dead worker assigned"
