"""The benchmark of record of ``repro_torch``: range search over a graph
index on one card. ``python rangebench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON line.

Everything a cell needs is found by name: its configuration under
``configs/``, its traffic mix under ``traffic/``, its own settings and
limits under ``workloads/``, and one reader a metric under ``metrics/``.
"""
