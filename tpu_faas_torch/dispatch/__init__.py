"""Dispatchers: consume the announce bus and place tasks on execution backends.

Modes (capability parity with reference task_dispatcher.py, SURVEY §1 L3):

- local    — in-process multiprocessing pool (reference :59-103)
- pull     — REP/REQ demand-driven workers (reference :105-187)
- push     — ROUTER/DEALER with LRU / process-LB / heartbeat (reference :189-472)
- tpu-push — push protocol with placement + liveness + redistribution computed
             as one batched JAX device step (this framework's north star)
"""

from tpu_faas_torch.dispatch.base import TaskDispatcher, PendingTask

__all__ = ["TaskDispatcher", "PendingTask"]
