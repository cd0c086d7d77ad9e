"""Device selection and host<->device copies shared by the port's modules."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` an entry point runs on. A CUDA device without a
    GPU present raises: the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a SNAPSHOT of ``host``.

    Host mirrors are mutated in place right after a tick is enqueued, so the
    copy must not read the live array later. On CUDA the snapshot is a
    pinned buffer and the copy is asynchronous on the current stream; the
    caching host allocator keeps the pinned block from being reused until
    that copy has run, so no host sync is needed here. On the CPU the
    snapshot is a numpy copy, and the tensor is that copy: no torch op
    runs, so the call never hands the interpreter lock to another thread
    (ROADMAP C.12)."""
    if device.type == "cuda":
        t = torch.from_numpy(np.ascontiguousarray(host))
        return t.pin_memory().to(device, non_blocking=True)
    return torch.from_numpy(np.array(host, order="C"))


def to_host(t: torch.Tensor | np.ndarray) -> np.ndarray:
    """Read a tensor back as numpy (a sync when it lies on the card); a
    numpy array (the multihost tick's outputs) passes through."""
    if isinstance(t, np.ndarray):
        return t
    if t.device.type == "cpu":
        # the tensor's own memory, in one call (ROADMAP C.12: each torch
        # call hands the interpreter lock to any thread that wants it); the
        # ticks' outputs never require grad
        return t.numpy()  # faas: allow(trace.host-sync) a CPU tensor's own memory: no device to wait for
    return t.detach().cpu().numpy()  # faas: allow(trace.host-sync) the port's readback; each call on the card's path is listed at its own site
