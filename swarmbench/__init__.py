"""The benchmark of ``swarmdb_tpu_torch``: agents served through SwarmDB.

One run is one cell of ``BENCHMARK.json`` (a model configuration under a
traffic mix) on the card it is started on::

    python3 -m swarmbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything a cell needs is found by name: its configuration file under
``configs/``, its traffic mix under ``mixes/``, its correctness limits
under ``limits/`` and its per-layer metrics under ``metrics/``. A new cell,
mix, configuration or metric is new files plus new entries in
``BENCHMARK.json``.

The yardstick lives here and not in the program: traffic generation
(``traffic``), the seeded weights (``weights``), the plain reference and
its prompt renderer (``reference``), the work counts, peaks and
percentiles (``yardstick``), the device trace reduction (``devtrace``)
and the comparison that decides ``correct`` (``correct``). Only
``drive`` imports the program.
"""
