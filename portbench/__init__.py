"""The benchmark of ``mgpgcr_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything that belongs to one configuration, one
traffic mix or one metric lives in a file of its own, found by name:
``configs/<config>.json``, ``traffic/<cell>.json``,
``e2e/<metric>.py`` and ``metrics/<metric>.py``. ``reference/`` holds
the plain float64 Wilson--Dirac operator that decides ``correct`` and
the byte models of the rooflines; it imports nothing of the program.
"""
