"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on an H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name: its configuration
in ``configs/``, its traffic mix in ``traffic/`` (a data file that names
the driver in ``drivers/``), its correctness limits in ``limits/``, each
metric's reader in ``metrics/``, each configuration's plain reference in
``reference/``, and the operation and byte counts in ``roofline/``.
"""
