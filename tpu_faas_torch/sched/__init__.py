"""Scheduler core on PyTorch: rank placement, the batch tick, the resident
delta tick and its fused CUDA kernel (see the package docstring)."""
