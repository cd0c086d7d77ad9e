"""Client SDK for the REST gateway (sync; async lives in
tpu_faas.client.aio, imported lazily so sync users don't pay for aiohttp)."""

from tpu_faas_torch.client.sdk import (
    FaaSClient,
    GraphBuilder,
    GraphNode,
    TaskCancelledError,
    TaskDependencyError,
    TaskExpiredError,
    TaskFailedError,
    TaskHandle,
)

# async names stay OUT of __all__: `import *` must not eagerly pull aiohttp
__all__ = [
    "FaaSClient", "TaskHandle", "GraphBuilder", "GraphNode",
    "TaskCancelledError", "TaskDependencyError", "TaskExpiredError",
    "TaskFailedError",
]

_LAZY_ASYNC = ("AsyncFaaSClient", "AsyncTaskHandle", "AsyncGraphBuilder",
               "AsyncGraphNode")


def __getattr__(name: str):
    if name in _LAZY_ASYNC:
        from tpu_faas_torch.client import aio

        return getattr(aio, name)
    raise AttributeError(name)
