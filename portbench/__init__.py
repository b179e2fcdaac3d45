"""The benchmark of the PyTorch port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last. Everything a cell is made of is found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py``.
"""
