"""The benchmark of kwave_tpu_torch on NVIDIA H100 cards: whole simulation jobs, timed.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs
one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything that belongs to
one configuration, traffic mix or per-layer metric is a file of its own here, found by
its name: ``configs/<config>.json`` with ``reference/<config>.py``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``.
"""
