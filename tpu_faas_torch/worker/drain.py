"""Graceful-shutdown signal wiring shared by both worker binaries.

First SIGTERM/SIGINT: drain — deregister, finish in-flight tasks, ship their
results, exit 0. Second signal: stop immediately — the drain may be stuck
behind a hung or very long task (the poison case), and an operator's repeat
Ctrl-C / a supervisor's escalation must still work without resorting to
SIGKILL. Signals arriving before the handlers are installed (interpreter
startup) take the default action and kill outright; that is the crash path,
which heartbeat-timeout purge + re-dispatch already recovers.
"""

from __future__ import annotations

import signal


def install_drain_signals(worker) -> None:
    """``worker`` needs ``drain()``, ``stop()``, and ``_draining``."""

    def handler(signum, frame) -> None:
        if worker._draining:
            worker.stop()  # second signal: exit now; `finally` cleans up
        else:
            worker.drain()

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
