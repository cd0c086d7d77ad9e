"""Worker runtime: pull (REQ) and push (DEALER) worker nodes.

Capability parity with reference pull_worker.py / push_worker.py: each worker
owns a local process pool executing `execute_fn` and speaks the dict-envelope
ZMQ protocol (SURVEY §2.3) to its dispatcher.
"""

from tpu_faas_torch.worker.pool import TaskPool

__all__ = ["TaskPool"]
