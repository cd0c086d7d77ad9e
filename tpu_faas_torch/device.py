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
    that copy has run, so no host sync is needed here."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def to_host(t: torch.Tensor) -> np.ndarray:
    """Read a tensor back as numpy (a sync when it lies on the card)."""
    return t.detach().cpu().numpy()
