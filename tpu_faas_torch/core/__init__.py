"""Execution core: serialization, task model, and the function executor.

Equivalent capability surface to the reference's helper_functions.py
(serialize/deserialize/execute_fn, reference helper_functions.py:5-28).
"""

from tpu_faas_torch.core.serialize import serialize, deserialize
from tpu_faas_torch.core.task import TaskStatus, Task, new_task_id
from tpu_faas_torch.core.executor import execute_fn, ExecutionResult

__all__ = [
    "serialize",
    "deserialize",
    "TaskStatus",
    "Task",
    "new_task_id",
    "execute_fn",
    "ExecutionResult",
]
