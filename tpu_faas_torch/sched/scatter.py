"""JAX's ``.at[idx]`` scatters with ``mode="drop"``, as torch ops.

An index that is masked off or out of range goes to a sentinel row N, one
past the end, which the scatter writes and then slices away.
"""

from __future__ import annotations

import torch


def drop_index(idx: torch.Tensor, mask: torch.Tensor, N: int) -> torch.Tensor:
    """JAX ``.at[idx]`` with ``mode="drop"``: a negative index wraps once;
    whatever is masked off or still outside [0, N) goes to the sentinel
    row N, which the scatter helpers below slice away."""
    idx = torch.where(idx < 0, idx + N, idx)
    return torch.where(mask & (idx >= 0) & (idx < N), idx, N).long()


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    buf = torch.cat([arr, arr.new_zeros(1)])
    buf[idx.long()] = vals
    return buf[:-1]


def scatter_add(arr: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    buf = torch.cat([arr, arr.new_zeros(1)])
    buf.index_put_((idx,), torch.as_tensor(vals, dtype=arr.dtype,
                                           device=arr.device)
                   .expand(idx.shape), accumulate=True)
    return buf[:-1]
