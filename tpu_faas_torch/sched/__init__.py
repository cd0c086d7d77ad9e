"""Scheduler core on PyTorch: rank, auction (with the bid's CUDA kernel) and
Sinkhorn placement, the batch tick, the resident delta tick and its fused
CUDA kernel (see the package docstring)."""
