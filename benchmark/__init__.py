"""The benchmark of ``tpu_faas_torch``: the resident scheduler's tick, one
cell at a time.

``python3 -m benchmark.run --workload NAME --seed N --seconds S --trace
0|1`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
The harness is driven by data: a cell's configuration is
``benchmark/configs/<config>.json``, its traffic mix
``benchmark/traffic/<traffic>.json`` and each per-layer metric
``benchmark/metrics/<metric>.py``, each found by the name that
``BENCHMARK.json`` gives. The plain reference that decides ``correct`` is
``benchmark/reference/``; it imports nothing of the program.
"""
