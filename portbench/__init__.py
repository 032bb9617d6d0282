"""The benchmark of the PyTorch and CUDA port (``codenerf_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; ``PERF.md`` says why
each cell, metric and limit is what it is. Nothing here imports JAX or
the JAX package, and ``portbench/reference/`` imports nothing of the port.
"""
