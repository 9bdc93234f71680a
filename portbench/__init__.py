"""The benchmark of ``horovod_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json``. Everything that belongs to one cell
is data: the configuration under ``configs/``, the traffic mix under
``traffic/``, the limits of its comparison under ``limits/``, and one
reader a per-layer metric under ``metrics/``. The plain references that
decide ``correct`` are under ``reference/`` and import nothing of the
program.
"""
