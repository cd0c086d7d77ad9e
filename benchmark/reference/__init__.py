"""The plain reference that decides ``correct``: the resident scheduler's
semantics in NumPy (``state``), its rank matching (``rank``) and its
auction (``auction``) in exact NumPy, and its bucketed Sinkhorn in plain
PyTorch (``sinkhorn``).
It imports nothing of the program and takes nothing the program made."""
