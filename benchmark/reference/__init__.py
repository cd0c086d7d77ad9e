"""The plain reference that decides ``correct``: the resident scheduler's
semantics in NumPy (``state``), its auction in exact float32 NumPy
(``auction``) and its bucketed Sinkhorn in plain PyTorch (``sinkhorn``).
It imports nothing of the program and takes nothing the program made."""
