"""Task store + announce bus.

The reference uses Redis db=1 as both the durable per-task hash store and the
announce bus (pub/sub channel "tasks") — reference task_dispatcher.py:30-36 and
the gateway contract in SURVEY §0.1. This package provides the same capability
behind a thin interface with three interchangeable backends:

- :class:`tpu_faas.store.memory.MemoryStore` — in-process, for tests, the
  local dispatcher, and the simulated fleets;
- :class:`tpu_faas.store.client.RespStore` — a client speaking a RESP2 subset
  over TCP, usable against either of the two servers below (or a real Redis);
- servers: ``tpu_faas.store.server`` (Python asyncio, fallback) and the native
  C++ server under ``native/`` (the performance path).
"""

from tpu_faas_torch.store.base import TaskStore, Subscription
from tpu_faas_torch.store.memory import MemoryStore

__all__ = ["TaskStore", "Subscription", "MemoryStore"]
