"""The benchmark of ``repro_torch``: one cell run once by ``run.py``.

``BENCHMARK.json`` at the repository root names the cells; everything
that belongs to one configuration, traffic mix, per-layer metric or
reference sits in a file of its own under this folder, found by name.
"""
