"""The dispatcher <-> worker wire vocabulary (:mod:`.messages`).

The workers themselves stay the JAX package's processes, unmodified: the
port's dispatcher speaks their wire, so only the message module is copied
here, and ``TaskPool`` (the worker's process pool) is not.
"""

from tpu_faas_torch.worker import messages

__all__ = ["messages"]
