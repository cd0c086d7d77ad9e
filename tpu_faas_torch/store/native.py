"""Launcher for the native C++ store server (native/store_server.cpp).

Builds on demand via the Makefile (g++ is the only requirement) and runs the
binary as a subprocess. Interface mirrors
:func:`tpu_faas.store.launch.start_store_thread`, so call sites can swap the
Python and native backends freely; both speak the identical RESP subset.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from dataclasses import dataclass

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
NATIVE_DIR = os.path.join(REPO_ROOT, "native")
BINARY = os.path.join(NATIVE_DIR, "build", "tpu-faas-store")


class NativeStoreUnavailable(RuntimeError):
    pass


def build_native_store(force: bool = False) -> str:
    """Compile the server if needed; returns the binary path."""
    src = os.path.join(NATIVE_DIR, "store_server.cpp")
    if (
        not force
        and os.path.exists(BINARY)
        and os.path.getmtime(BINARY) >= os.path.getmtime(src)
    ):
        return BINARY
    try:
        subprocess.run(
            ["make", "-C", NATIVE_DIR],
            check=True,
            capture_output=True,
            text=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError) as exc:
        detail = getattr(exc, "stderr", "") or str(exc)
        raise NativeStoreUnavailable(
            f"could not build native store: {detail}"
        ) from exc
    return BINARY


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class NativeStoreHandle:
    process: subprocess.Popen
    host: str
    port: int

    @property
    def url(self) -> str:
        return f"resp://{self.host}:{self.port}"

    def stop(self) -> None:
        if self.process.poll() is None:
            self.process.terminate()
            try:
                self.process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.process.kill()
                self.process.wait()


def start_native_store(
    host: str = "127.0.0.1",
    port: int = 0,
    timeout: float = 10.0,
    snapshot_path: str | None = None,
    autosave_interval: float = 0.0,
    replica_of: str | None = None,
) -> NativeStoreHandle:
    """Build (if needed) and launch the native store; blocks until it accepts
    connections.

    ``replica_of`` is the HA launch hook matching the Python server's
    ``--replica-of`` (store/replication.py). The C++ server does not
    implement the replication stream yet, so requesting it here fails
    fast with a pointer at the Python server instead of launching a
    store that silently is not a replica."""
    if replica_of is not None:
        raise NativeStoreUnavailable(
            "the native store does not implement the replication stream "
            "(REPLSYNC) yet; run BOTH ends of an HA pair as "
            "`python -m tpu_faas.store.server` (the replica as "
            f"`--replica-of {replica_of}`)"
        )
    binary = build_native_store()
    if port == 0:
        port = _free_port()
    argv = [binary, "--host", host, "--port", str(port)]
    if snapshot_path is not None:
        argv += ["--snapshot", snapshot_path]
    if autosave_interval > 0:
        argv += ["--autosave", str(autosave_interval)]
    proc = subprocess.Popen(
        argv,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            out = proc.stdout.read() if proc.stdout else ""
            raise NativeStoreUnavailable(
                f"native store exited at startup: {out}"
            )
        try:
            with socket.create_connection((host, port), timeout=0.2):
                return NativeStoreHandle(proc, host, port)
        except OSError:
            time.sleep(0.02)
    proc.kill()
    raise NativeStoreUnavailable("native store did not start in time")
