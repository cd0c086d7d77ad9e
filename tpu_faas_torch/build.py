"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
plain-C shared library under ``csrc/build/`` (listed in ``.gitignore``),
named by a hash of its source and flags, so an unchanged source is built
once per checkout and a changed one never loads a stale library. The
libraries are loaded with ``ctypes``; :func:`check_arg` is the check each
wrapper makes on a tensor before it hands the kernel a raw pointer.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    library path and nvcc's ptxas report (empty for a library that was
    already built). Raises if the build fails."""
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: processes building the same
    # source at once never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"CUDA build of {name} failed: nvcc exited {proc.returncode}\n"
            f"{proc.stdout}"
        )
    os.replace(tmp, lib)
    return lib, proc.stdout


def check_arg(t: torch.Tensor, name: str, dtype, n: int, dev) -> None:
    """Raise unless ``t`` is a contiguous ``dtype[n]`` on ``dev``."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the kernel runs on {dev}")
    if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype}[{n}], got "
            f"{t.dtype}{list(t.shape)} contiguous={t.is_contiguous()}"
        )
