"""TorchScript for the ticks that run as many small torch ops on the host.

Each torch call from Python releases the interpreter lock around its op and
takes it back afterwards. A tick of hundreds or thousands of small ops (the
batch rank tick on the CPU, the mesh's Sinkhorn tick) then waits for the
lock once an op wherever other threads of its process run Python: the
dispatcher's gateway, store and client threads, in the tests and in a
one-process deployment. JAX's tick is one compiled call. Here such a tick
is one call of a function TorchScript compiled (:func:`scripted`), which
releases the lock once for the whole tick (ROADMAP C.11, C.12).

:func:`call` runs it with the graph executor's optimisations off, a
setting of the calling thread alone: no profiling runs, no fuser (NNC
would fuse elementwise ops on a CUDA build and change their bits), the ops
as written, so the result is the eager ops' bit for bit. A body that does
not compile raises; there is no eager fallback. :class:`CallCount`
counts a tick's torch calls from Python.
"""

from __future__ import annotations

import functools
import warnings

import torch
from torch.overrides import TorchFunctionMode


@functools.cache
def scripted(body):
    """``body`` compiled by TorchScript, once a process."""
    with warnings.catch_warnings():
        # deprecated in favour of torch.compile, which would rewrite the
        # ops (and needs a compiler); the scripted graph runs them as
        # written
        warnings.simplefilter("ignore", DeprecationWarning)
        return torch.jit.script(body)


def call(body, *args):
    """One call of ``body``'s compiled form, unoptimised (above)."""
    with torch.jit.optimized_execution(False):
        return scripted(body)(*args)


class CallCount(TorchFunctionMode):
    """Counts the torch calls made from Python while it is active, each a
    release and retake of the interpreter lock around its op; a scripted
    call counts as one, the ops inside it as none (``with CallCount() as
    c: ...``, then ``c.n``)."""

    def __init__(self) -> None:
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))
