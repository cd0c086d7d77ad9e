"""Scheduler core on PyTorch: rank and auction placement (with the bid's
CUDA kernel), the batch tick, the resident delta tick and its fused CUDA
kernel (see the package docstring)."""
