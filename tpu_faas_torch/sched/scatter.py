"""JAX's ``.at[idx]`` scatters with ``mode="drop"``, and XLA's f32 -> i32
conversion, as torch ops.

An index that is masked off or out of range goes to a sentinel row N, one
past the end, which the scatter writes and then slices away.
"""

from __future__ import annotations

import torch

_I32 = torch.int32
_I32_MAX = 2**31 - 1


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 as XLA (and CUDA's ``__float2int_rz``) convert:
    truncate toward zero, saturate at the int32 range, NaN -> 0."""
    i = x.clamp(-(2.0**31), 2147483520.0).to(_I32)
    i = torch.where(x >= 2.0**31, _I32_MAX, i)
    return torch.where(torch.isnan(x), 0, i).to(_I32)


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
    if isinstance(vals, torch.Tensor):
        vals = vals.to(arr.dtype).expand(idx.shape)
    else:  # filled on the device: no host-to-device copy of the scalar
        vals = torch.full(idx.shape, vals, dtype=arr.dtype, device=arr.device)
    buf.index_put_((idx,), vals, accumulate=True)
    return buf[:-1]
