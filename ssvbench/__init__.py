"""The benchmark of ``havac_tpu_torch``: searches served through
``Havac.scan_files`` on one CUDA card, held to a plain reference.

``python -m ssvbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON result
line last. Configurations, traffic mixes, per-layer metrics and kernel
costs are files found by name under ``configs/``, ``traffic/``,
``metrics/`` and ``kernel_cost/``; ``reference/`` is the plain reference
that decides ``correct``. Nothing here imports JAX or the JAX package.
"""
