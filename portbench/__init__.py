"""The benchmark of the PyTorch and CUDA port (``vtkcloudpoint_tpu_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
metric sits in a file of its own, found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``job`` names a module in ``jobs/``),
``limits/<config>.<job>.json`` and ``metrics/<metric>.py``.
"""
